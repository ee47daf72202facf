"""JAX/Pallas SPH (smoothed particle hydrodynamics) stepper.

The live frame producer for the trajectory pipeline: weakly-compressible
SPH with cell-list neighbor search, kernel-weighted density summation,
Tait equation of state, artificial viscosity, and a symplectic integrator
(the SPH formulation the reference's schema fields serve:
pgsd/doc/pgsd.tex:525-565 - slength/density/pressure/energy chunks).

Design:

* fixed-capacity dense cell layout ``[n_cells+1, capacity]`` - static
  shapes, masked slots, sentinel row for out-of-range neighbors; built
  with one XLA sort per step.
* the density, accel and fused accel+drho neighbour sweeps run as
  Triton Pallas kernels on a GPU (``tpgsd.sph.pair_kernel``) and as
  blocked jnp elsewhere (``tpgsd.sph.step``).
* multi-device scaling by sharding the cell axis into spatial slabs
  (x-major linear cell index) - XLA inserts the halo collectives; the
  SPH analogue of context parallelism.
"""

from .kernels import CubicSpline, WendlandC2  # noqa: F401
from .cells import (  # noqa: F401
    CellGrid,
    build_cells,
)
from .step import (  # noqa: F401
    SPHParams,
    SPHState,
    density_and_pressure,
    energy_rate,
    init_density,
    make_adaptive_step_fn,
    make_step_fn,
    run_adaptive,
)
from .dam_break import dam_break  # noqa: F401
from .scenarios import (  # noqa: F401
    Scenario,
    dam_break_2d,
    hydrostatic_tank,
    still_box,
    still_box_2d,
    taylor_green,
)
from .bigstep import make_slab_step_fn, slab_init_density  # noqa: F401
from .checkpoint import (  # noqa: F401
    resume,
    resume_distributed,
    resume_distributed2d,
    resume_distributed3d,
)
from .distributed import (  # noqa: F401
    DistAux,
    DistState,
    CollectedState,
    collect_aux,
    collect_state,
    distribute_state,
    make_adaptive_distributed_step_fn,
    make_distributed_step_fn,
)
from .distributed2d import (  # noqa: F401
    distribute_state_2d,
    make_adaptive_distributed2d_step_fn,
    make_distributed2d_step_fn,
)
from .distributed3d import (  # noqa: F401
    distribute_state_3d,
    make_adaptive_distributed3d_step_fn,
    make_distributed3d_step_fn,
)
