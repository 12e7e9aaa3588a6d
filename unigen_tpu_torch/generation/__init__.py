from .decode import generate_text, mmu_generate  # noqa: F401
from .t2i import t2i_generate, t2i_generate_ar  # noqa: F401
