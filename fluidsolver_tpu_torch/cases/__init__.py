from fluidsolver_tpu_torch.cases.registry import Case, get_case, list_cases

__all__ = ["Case", "get_case", "list_cases"]
