from .model import Model, resolve_device  # noqa: F401
