from .pipeline import SyntheticLMData, make_batch_specs  # noqa: F401
