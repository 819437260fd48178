"""Type aliases (port of flashgmm_tpu/typing.py; cf. compressai/typing)."""

from typing import Any, Callable, Dict, List, Tuple, Union

import torch

Array = torch.Tensor
PyTree = Any
StringList = List[bytes]
StringsLike = Union[List[bytes], Tuple[Any, ...]]
ShapeLike = Union[Tuple[int, ...], Dict[str, Any]]
ModuleFactory = Callable[..., Any]
