from . import checkpoint, serve_step, train_step  # noqa: F401
