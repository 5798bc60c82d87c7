from fluidsolver_tpu_torch.cases.registry import Case, get_case, list_cases
import fluidsolver_tpu_torch.cases.sources  # noqa: F401  (growing IB, expanding bubble)

__all__ = ["Case", "get_case", "list_cases"]
