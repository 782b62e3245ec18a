from .dadapt import DAdaptAdam  # noqa: F401
