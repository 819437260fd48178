"""Name -> class registries with decorator registration (port of
flashgmm_tpu/registry/registry.py; CompressAI's compressai/registry/
torch.py:44-120). Importing a module registers what it defines, so a
registry holds the models, criteria and optimizers of the modules imported
so far."""

from typing import Callable, Dict

CRITERIONS: Dict[str, Callable] = {}
DATASETS: Dict[str, Callable] = {}
MODELS: Dict[str, Callable] = {}
MODULES: Dict[str, Callable] = {}
OPTIMIZERS: Dict[str, Callable] = {}
SCHEDULERS: Dict[str, Callable] = {}
TRANSFORMS: Dict[str, Callable] = {}


def _register(registry: Dict[str, Callable], name: str = None):
    def decorator(cls):
        registry[name if name is not None else cls.__name__] = cls
        return cls

    return decorator


def register_criterion(name: str = None):
    return _register(CRITERIONS, name)


def register_dataset(name: str = None):
    return _register(DATASETS, name)


def register_model(name: str = None):
    return _register(MODELS, name)


def register_module(name: str = None):
    return _register(MODULES, name)


def register_optimizer(name: str = None):
    return _register(OPTIMIZERS, name)


def register_scheduler(name: str = None):
    return _register(SCHEDULERS, name)


def register_transform(name: str = None):
    return _register(TRANSFORMS, name)
