"""The device mesh and its sharding helpers (port of
flashgmm_tpu/parallel/mesh.py).

A :class:`Mesh` is a (data, spatial) grid of ``torch.device`` slots: the
``data`` axis splits a batch, the ``spatial`` axis splits image height. One
process drives every slot. ``make_mesh`` takes the first cards
``torch.cuda.device_count()`` gives and raises when fewer exist than asked:
it never quietly takes fewer cards and never puts two slots on one card. A
mesh of several slots on one card, or on the CPU, is built by naming its
devices (``Mesh([torch.device("cuda", 0)] * 4)``) or, on the CPU only, by
``make_mesh(n, device="cpu")``, for tests.

``shard_batch`` splits an NHWC batch over the grid; ``replicate`` gives one
snapshot of a module a slot, on that slot's device.
"""

import copy

import torch

AXES = ("data", "spatial")


class Mesh:
    """A 2-D grid of device slots and its axis names. ``devices``: a list
    of devices (the data axis, spatial 1) or a list of rows of them
    (data x spatial); anything ``torch.device`` takes."""

    def __init__(self, devices, axis_names=AXES):
        rows = [list(r) if isinstance(r, (list, tuple)) else [r]
                for r in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError(f"Mesh: not a non-empty grid: {devices!r}")
        if tuple(axis_names) != AXES:
            raise ValueError(f"Mesh: axis names {axis_names!r}, not {AXES}")
        self.devices = [[torch.device(d) for d in r] for r in rows]
        self.axis_names = AXES

    @property
    def shape(self):
        """{"data": rows, "spatial": columns}, as JAX's ``Mesh.shape``."""
        return {"data": len(self.devices), "spatial": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self):
        """Every slot's device, row by row (JAX's ``devices.flat``)."""
        return [d for r in self.devices for d in r]

    def axis_devices(self, axis: str):
        """The slots along ``axis`` through the first slot: the first column
        for "data", the first row for "spatial". A sharded call splits its
        input over these; the other axis holds replicas."""
        if axis == "data":
            return [r[0] for r in self.devices]
        if axis == "spatial":
            return list(self.devices[0])
        raise ValueError(f"Mesh: no axis {axis!r} (axes {AXES})")

    def __repr__(self):
        rows = [[str(d) for d in r] for r in self.devices]
        return f"Mesh({self.shape}, {rows})"


def make_mesh(n_devices: int = None, data: int = None, spatial: int = 1,
              device: str = "cuda"):
    """A ("data", "spatial") mesh over the first ``n_devices`` cards (all
    of them by default), ``data`` x ``spatial`` (``data`` defaults to
    ``n_devices // spatial``). Raises RuntimeError when fewer cards exist
    than asked. ``device="cpu"`` builds ``n_devices`` (default 1) slots on
    the CPU, for tests."""
    if device == "cpu":
        devices = [torch.device("cpu")] * (1 if n_devices is None
                                           else int(n_devices))
    elif device == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices is None:
            n_devices = count
        if count < n_devices or n_devices < 1:
            raise RuntimeError(
                f"make_mesh: requested {n_devices} devices but torch.cuda "
                f"exposes only {count}. A mesh takes one slot a card; name "
                "the devices (Mesh([...])) to put several slots on one card, "
                "or pass device='cpu' for CPU slots.")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        raise ValueError(f"make_mesh: device {device!r}, not 'cuda' or 'cpu'")
    n_devices = len(devices)
    if data is None:
        data = n_devices // spatial
    if data * spatial != n_devices:  # JAX's assert, kept under -O
        raise AssertionError((data, spatial, n_devices))
    return Mesh([devices[i * spatial:(i + 1) * spatial] for i in range(data)])


def split_batch(t, n: int, dim: int = 0):
    """``t`` split along ``dim`` into at most n nonempty parts, the first
    ``size % n`` one longer (``torch.tensor_split``)."""
    return [p for p in torch.tensor_split(t, n, dim=dim) if p.shape[dim]]


def shard_batch(mesh: Mesh, batch):
    """An NHWC batch split over the mesh: [data][spatial] shards, each on
    its slot's device, the batch split along the data axis and each part's
    height along the spatial axis (parts differ by one at most)."""
    data = split_batch(batch, mesh.shape["data"])
    return [[p.to(dev) for p, dev in zip(split_batch(b, len(row), 1), row)]
            for b, row in zip(data, mesh.devices)]


def snapshot(module, device):
    """A copy of ``module`` on ``device``. Convs that ``route_bf16_kernel``
    sent to the bf16 conv kernel pack their weights again there: the packed
    weights are no parameters and would stay on the first card."""
    copy_ = copy.deepcopy(module).to(device)
    for m in copy_.modules():
        if getattr(m, "kernel_route", False):
            m.route_bf16_kernel()
    return copy_


def replicate(mesh: Mesh, tree):
    """One snapshot of ``tree`` (a module or a tensor) a slot of the mesh,
    in ``mesh.flat`` order, each on its slot's device."""
    if isinstance(tree, torch.Tensor):
        return [tree.to(dev, copy=True) for dev in mesh.flat]
    return [snapshot(tree, dev) for dev in mesh.flat]
