"""Programming-model frontends.

Each module offers the idiom of its model (OpenMP directive stacks, OpenACC data
regions with gang/vector loops, CUDA grid/block kernel launches) and desugars to
UPIR through the shared ``PlanBuilder``. Semantically-equivalent programs written
in different frontends produce structurally identical ``ir.Program``s after
normalization — the paper's C1 claim, asserted by tests/test_upir_frontends.py.
"""
from . import omp, acc, cuda  # noqa: F401
