"""Sharded inference over a mesh (port of flashgmm_tpu/parallel/inference.py).

- ``make_sharded_forward``: the likelihood forward with the batch split
  over the mesh's data axis, each slot's share through the model's copy on
  its device.
- ``make_spatial_sharded_transform`` (g_a) and
  ``make_spatial_sharded_forward`` (the whole model): one image split over
  the spatial axis by height, the 2K+ single-image path (spatial sharding
  as the image analog of sequence parallelism).

Each returns a callable with the JAX function's signature and outputs,
gathered on the axis's first device, and runs the forward as
``model(x, training=False)`` without autograd.

Height sharding runs as XLA's SPMD program does, layer by layer: each slot
holds a band of whole units of the model's total stride (64 rows for the
hyperprior models: g_a's 16 times h_a's 4; 16 for g_a alone), the bands
differing by one unit at most (3840x2176 splits 9/9/8/8 over four cards),
so every band starts on an even row of every activation and the
checkerboard's parity holds band by band. One thread a band runs the
model's own forward on its band and card: the threads are the SPMD
program's ranks. Before each conv and transposed conv whose kernel reaches
past the band (``torch.conv2d``, ``torch.conv_transpose2d``, seen through
a ``TorchFunctionMode`` of the thread) the band takes the halo rows from
its neighbours' bands (``Tensor.to``: peer to peer where the cards allow
it), zeros past the image's edges, and the conv runs without height
padding. Every other layer (GDN, the activations, the entropy models) is
per position and runs on the band alone. A halo deeper than a
neighbour's band raises: rows from beyond the next card are never
fetched. Nothing is recomputed, unlike the tiles of ``runtime/tiled.py``,
whose halos would span the whole forward's receptive field.
"""

import copy
import threading
from contextlib import nullcontext

import torch
from torch.overrides import TorchFunctionMode

from .mesh import snapshot, split_batch

BARRIER_TIMEOUT_S = 600.0  # a band that never reaches its next conv


def _replicas(model, devices):
    """The model on each slot's device: itself on its own device, one
    snapshot for each other device."""
    made = {next(model.parameters()).device: model}
    for d in devices:
        if d not in made:
            made[d] = snapshot(model, d)
    return [made[d] for d in devices]


def _gather(parts, dim, device):
    """Per-slot outputs (tensors, or dicts of them) concatenated along
    ``dim`` on ``device``."""
    if isinstance(parts[0], dict):
        return {k: _gather([p[k] for p in parts], dim, device)
                for k in parts[0]}
    return torch.cat([p.to(device) for p in parts], dim)


def make_sharded_forward(model, mesh, axis: str = "data"):
    """The likelihood forward ``model(x, training=False)`` with the batch
    split over ``axis``; outputs gathered on the axis's first device."""
    devices = mesh.axis_devices(axis)
    models = _replicas(model, devices)

    def run(x):
        with torch.no_grad():
            outs = [m(p.to(d), training=False) for m, d, p in
                    zip(models, devices, split_batch(x, len(devices)))]
        return _gather(outs, 0, devices[0])

    return run


def _pair(v):
    if isinstance(v, str):
        raise NotImplementedError(f"height sharding: padding {v!r}")
    return (v, v) if isinstance(v, int) else tuple(v)


class _Exchange:
    """The halo exchange of one height-sharded call: at each conv that
    needs a halo, band i posts its first and last rows and waits for every
    band at a barrier, then reads its neighbours' posts."""

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.posts = {}
        self.steps = [0] * n

    def __call__(self, i, head, tail):
        """Post band i's ``head`` (the rows the band above needs) and
        ``tail`` (the rows the band below needs); return (the band above's
        tail, the band below's head), None past the image's edges."""
        step = self.steps[i]
        self.steps[i] += 1
        self.posts[(step, i)] = (head, tail)
        self.barrier.wait(BARRIER_TIMEOUT_S)
        # every band has read the last step's posts before this barrier
        self.posts.pop((step - 1, i), None)
        return (self.posts[(step, i - 1)][1] if i > 0 else None,
                self.posts[(step, i + 1)][0] if i < self.n - 1 else None)


class _HaloMode(TorchFunctionMode):
    """Band i's convs with their halos from the neighbouring bands."""

    def __init__(self, exchange, i):
        super().__init__()
        self.exchange = exchange
        self.i = i

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.conv2d:
            return self._conv(*args, **kwargs)
        if func is torch.conv_transpose2d:
            return self._conv_transpose(*args, **kwargs)
        return func(*args, **kwargs)

    def _halo(self, x, top, bottom):
        """x (NCHW, this band's rows) with ``top`` rows of the band above
        and ``bottom`` of the band below around it, zeros past the
        image."""
        if top == 0 and bottom == 0:
            return x
        if self.exchange.n > 1 and x.shape[2] < max(top, bottom):
            raise ValueError(
                f"height sharding: a halo of {max(top, bottom)} rows needs "
                f"rows from beyond the next card (its band holds "
                f"{x.shape[2]}); use fewer cards or a taller image")
        above, below = self.exchange(self.i, x[:, :, :bottom],
                                     x[:, :, x.shape[2] - top:])
        shape = list(x.shape)

        def rows(t, n):
            if t is not None:
                return t.to(x.device)
            shape[2] = n
            return x.new_zeros(shape)

        return torch.cat([rows(above, top), x, rows(below, bottom)], 2
                         ).contiguous(memory_format=torch.channels_last)

    def _conv(self, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        (sh, sw), (ph, pw), (dh, dw) = (_pair(stride), _pair(padding),
                                        _pair(dilation))
        rows = x.shape[2]
        if rows % sh:
            raise ValueError(f"height sharding: a band of {rows} rows "
                             f"under a stride-{sh} conv")
        k = dh * (w.shape[2] - 1) + 1
        y = torch.conv2d(self._halo(x, ph, max(k - sh - ph, 0)), w, b,
                         (sh, sw), (0, pw), (dh, dw), groups)
        return y[:, :, :rows // sh]

    def _conv_transpose(self, x, w, b=None, stride=1, padding=0,
                        output_padding=0, groups=1, dilation=1):
        (sh, sw), (ph, pw), (oh, ow), (dh, dw) = (
            _pair(stride), _pair(padding), _pair(output_padding),
            _pair(dilation))
        k = dh * (w.shape[2] - 1) + 1
        if k - 2 * ph + oh != sh:
            raise ValueError("height sharding: a transposed conv whose "
                             "output is not stride times its input")
        rows = x.shape[2]
        top, bottom = (k - 1 - ph) // sh, (ph + sh - 1) // sh
        y = torch.conv_transpose2d(self._halo(x, top, bottom), w, b,
                                   (sh, sw), (0, pw), (0, ow), groups,
                                   (dh, dw))
        start = top * sh + ph
        return y[:, :, start:start + rows * sh]


def _spmd(devices, fns):
    """fns[i]() on a thread of its own, on devices[i], under band i's halo
    exchange and without autograd: their results. The first error of a
    band is raised; the others' barrier is broken so that none waits."""
    exchange = _Exchange(len(fns))
    results = [None] * len(fns)
    errors = [None] * len(fns)

    def body(i):
        dev = devices[i]
        try:
            with torch.no_grad(), (torch.cuda.device(dev)
                                   if dev.type == "cuda" else nullcontext()), \
                    _HaloMode(exchange, i):
                results[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
            exchange.barrier.abort()

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        first = [e for e in raised
                 if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or raised)[0]
    return results


def _stride(module, c_in, side=256):
    """(rows of the input a row of ``module``'s output covers, its output
    channels), from a run on the meta device."""
    out = copy.deepcopy(module).to("meta")(
        torch.empty(1, side, side, c_in, device="meta"))
    return side // out.shape[1], out.shape[-1]


def _model_unit(model):
    """The model's total stride: g_a's, times its hyper branch's h_a's."""
    unit, c = _stride(model.g_a, 3)
    for m in model.modules():
        h_a = getattr(m, "h_a", None)
        if m is not model and isinstance(h_a, torch.nn.Module):
            return unit * _stride(h_a, c)[0]
    return unit


def _bands(x, n, unit):
    """x [B, H, W, C] split by height into n bands of whole ``unit``-row
    units, the first ones a unit taller where they do not divide evenly."""
    h = x.shape[1]
    if h % unit or h // unit < n:
        raise ValueError(f"height sharding: {h} rows are not {n} or more "
                         f"whole units of {unit} rows")
    q, r = divmod(h // unit, n)
    return torch.split(x, [unit * (q + (i < r)) for i in range(n)], dim=1)


def _spatial(model, mesh, axis, unit, call):
    devices = mesh.axis_devices(axis)
    models = _replicas(model, devices)

    def run(x):
        bands = _bands(x, len(devices), unit)
        outs = _spmd(devices, [
            lambda m=m, d=d, band=band: call(m, band.to(d))
            for m, d, band in zip(models, devices, bands)])
        return _gather(outs, 1, devices[0])

    return run


def make_spatial_sharded_transform(model, mesh, axis: str = "spatial"):
    """g_a with the image split by height over ``axis`` (bands of whole
    units of g_a's stride); y gathered on the axis's first device."""
    return _spatial(model, mesh, axis, _stride(model.g_a, 3)[0],
                    lambda m, band: m.g_a(band))


def make_spatial_sharded_forward(model, mesh, axis: str = "spatial"):
    """The FULL likelihood forward ``model(x, training=False)`` (analysis,
    hyper branch, context, entropy models, synthesis) with every
    activation split by height over ``axis``: bands of whole units of the
    model's total stride, halos exchanged layer by layer. Outputs gathered
    on the axis's first device."""
    return _spatial(model, mesh, axis, _model_unit(model),
                    lambda m, band: m(band, training=False))
