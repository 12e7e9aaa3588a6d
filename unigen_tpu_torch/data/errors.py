"""The two ways an image fails to decode (``data/decode.py`` and the format
modules beside it)."""


class CorruptImage(ValueError):
    """Bytes that are no image, or a broken one: a bad sample."""


class UnsupportedImageFormat(RuntimeError):
    """An image format the port does not decode."""
