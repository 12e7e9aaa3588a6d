from .t2i import t2i_generate  # noqa: F401
