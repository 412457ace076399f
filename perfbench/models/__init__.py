"""One module an architecture, named by the configuration's ``arch``: its
weight maker (from the seed, on the device), the dimensions and packed
matrices the metrics count, and the program's configuration and
parameter tree over the made tensors (``port_config``, ``port_params``;
these import the program inside the function). The plain forward of the
same architecture is ``perfbench/reference/<arch>.py``."""
import importlib


def get(cfg: dict):
    """The model module of the configuration's architecture."""
    return importlib.import_module(f"perfbench.models.{cfg['arch']}")
