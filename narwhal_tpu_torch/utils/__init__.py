from . import serde  # noqa: F401
