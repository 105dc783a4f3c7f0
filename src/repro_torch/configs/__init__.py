from .registry import ARCH_NAMES, RECIPES, get_config, get_recipe
from .shapes import SHAPES, LONG_CONTEXT_ARCHS, cells
