from fluidsolver_tpu_torch.cases.registry import Case, get_case, list_cases
import fluidsolver_tpu_torch.cases.sources  # noqa: F401  (growing IB, expanding bubble)
import fluidsolver_tpu_torch.cases.dfg  # noqa: F401  (the three DFG cylinder cases)
import fluidsolver_tpu_torch.cases.immersed_interface  # noqa: F401  (the marker ring)

__all__ = ["Case", "get_case", "list_cases"]
