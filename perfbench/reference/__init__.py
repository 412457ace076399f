"""Plain references: PyTorch alone, importing nothing of the program. One
module an architecture, named by the configuration's ``arch``."""
import importlib


def get(cfg: dict):
    """The plain reference of the configuration's architecture."""
    return importlib.import_module(f"perfbench.reference.{cfg['arch']}")
