from .adam import Adam  # noqa: F401
from .dadapt import DAdaptAdam  # noqa: F401
