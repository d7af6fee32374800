"""madnlp_tpu_torch — the PyTorch/CUDA port of madnlp_tpu.

The filter line-search interior-point method of ``madnlp_tpu`` on PyTorch
tensors, with the TPU kernels of the JAX package written by hand for NVIDIA
Hopper (``csrc/``): the banded sparse direct factorization (streaming,
batched and whole-band) and the whole-matrix dense LDLᵀ.  The JAX package
is the reference this port is held against; the port imports nothing of
it.

Models come in as dense callbacks (``create_model``, derivatives from
``torch.func``), sparse ones (``SparseNLPModel``), AMPL ``.nl`` files
(``read_nl``, ``solve_nl``, ``write_sol``; the solver executable
``madnlp-tpu-torch-ampl``), ``scipy.optimize`` vocabulary
(``from_scipy``), opaque NumPy callbacks run on the host (``host_model``)
or MATPOWER case files (``models.matpower``, which the package root does
not re-export, as in the JAX package).  Solver state,
residuals and iterative refinement are float64; only the KKT factor and
its solves use ``opts.dtype``.  Float32 products must be true float32, so
TF32 is switched off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .models.model import (  # noqa: E402
    DenseNLPModel,
    NLPModel,
    SparseNLPModel,
    create_model,
)
from .models.frontends import from_scipy, host_model  # noqa: E402
from .models.nl import read_nl, solve_nl, write_sol  # noqa: E402
from .utils.options import (  # noqa: E402
    BarrierUpdate,
    EqualityTreatment,
    FixedVariableTreatment,
    HessianApproximation,
    InertiaCorrection,
    KKTSystem,
    LinearSolver,
    MadNLPOptions,
    PrintLevel,
    RichardsonOptions,
)
from .utils.status import Status, is_success  # noqa: E402
from .ipm.solver import (  # noqa: E402
    ExecutionStats,
    MadNLPSolver,
    batch_summary,
    madnlp,
)

__all__ = [
    "create_model", "DenseNLPModel", "NLPModel", "SparseNLPModel",
    "from_scipy", "host_model", "read_nl", "solve_nl", "write_sol",
    "MadNLPOptions", "KKTSystem", "LinearSolver",
    "InertiaCorrection", "BarrierUpdate", "HessianApproximation",
    "FixedVariableTreatment", "EqualityTreatment",
    "PrintLevel", "RichardsonOptions", "Status", "is_success",
    "MadNLPSolver", "ExecutionStats", "madnlp", "batch_summary",
]
