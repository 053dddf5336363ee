# Submodules are imported by callers (`from repro_torch.core import fp8`).
__all__ = ["characterization", "execution", "fp8", "paging", "sparsity", "tree"]
