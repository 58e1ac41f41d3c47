from .model import LanguageModel, build  # noqa: F401
