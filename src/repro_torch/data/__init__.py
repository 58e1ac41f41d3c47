from .pipeline import SyntheticLMData  # noqa: F401
