# Submodules are imported by callers (`from repro_torch.core import fp8`).
__all__ = ["execution", "fp8"]
