"""The training steps (port of make_train_state, data_parallel_train_step,
vbr_train_step, video_train_step and pointcloud_train_step,
flashgmm_tpu/parallel/train.py:15-161), on one process or over a
``torch.distributed`` process group.

The JAX step shards its batch over a mesh and XLA inserts the gradient
all-reduce. Here every rank of a group holds its rows of one global batch,
split evenly in rank order, and the parameters (equal on every rank: see
``parallel/distributed.py::broadcast_parameters``); one all-reduce a step
sums the flat gradient, the loss and the logged terms, then divides by the
world size. Each rank's loss is a mean over its own rows, so that mean over
the ranks is the global batch's (``local_rows`` refuses a batch the ranks
cannot split evenly), and every rank ends the step with the parameters one
process's step gives on the whole batch, up to float32 summation order.
``torch.nn.parallel.DistributedDataParallel`` is not used: its reducer
hooks the accumulation of ``.grad``, which ``torch.autograd.grad`` never
does. The training noise of a rank is its rows of the whole batch's noise
(``entropy_models.RankNoise``), so the step over W ranks draws what the
step on one process draws. With no group, or a world of 1, a step is the
one-process step bit for bit.

The order of the JAX step is kept:
1. the rate-distortion loss of the training forward (uniform noise from
   ``generator``) and its gradients for the "net" parameters;
2. the non-finite guard: if the loss or any gradient is not finite, every
   gradient becomes zero. The step is not skipped: like optax's Adam,
   ``torch.optim.Adam`` then moves the parameters by their decayed
   momentum and counts the step, because each gradient is a zero tensor,
   never ``None`` (Adam skips a parameter whose gradient is ``None``).
   Over a group the guard reads the global loss and gradient, so a NaN in
   one rank's rows zeroes the step on every rank;
3. optax's ``clip_by_global_norm``: ``g`` if ``||g|| < max``, else
   ``g / ||g|| * max`` (``torch.nn.utils.clip_grad_norm_`` divides by
   ``||g|| + 1e-6`` instead), on the global gradient's norm;
4. the net Adam step;
5. the aux loss of the updated model, its gradients for the quantiles
   alone (equal on every rank; reduced all the same, which keeps the
   replicas equal by construction), the same guard, the aux Adam step.

``vbr_train_step`` is the same step for the VBR models (``models/vbr.py``)
at one gain level: their stage-2 forward at ``s``, the loss ``lmbda * 255^2
* mse + bpp``. ``Gain`` is a "net" parameter that reaches no loss (the
forward detaches it), so its gradient is a zero tensor and Adam leaves it
where it is, as under the reference's ``stop_gradient``.

``video_train_step`` is the same step for the video model (ssf2020) on a
GOP: its forward over the frames, ``video_rate_distortion_loss``.

``pointcloud_train_step`` is the same step for the point-cloud codecs on
[B, N, 3] clouds: the chamfer RD loss (the PointNet family, whose layers
normalise each cloud alone) or the density-preserving one (hrtzxf2022,
whose weights are its own; ``lmbda`` is unused there). hrtzxf2022's loss
holds ``|sum over the batch - target|``, which no mean of the ranks'
losses gives, so its step runs on one process only.

No library settings are pinned on the card: a training step's result
depends on no coded bytes, so it runs under the caller's (the trainer
leaves TF32 at PyTorch's defaults and lets cuDNN time its algorithms).
"""

import torch
import torch.distributed as dist

from flashgmm_tpu_torch.entropy_models.entropy_models import RankNoise
from flashgmm_tpu_torch.losses import (ChamferPccRateDistortionLoss,
                                       RateDistortionLossHrtzxf2022,
                                       rate_distortion_loss,
                                       video_rate_distortion_loss)
from flashgmm_tpu_torch.optimizers.net_aux import make_adam, net_aux_partition

from .distributed import active_group


def make_train_state(model, learning_rate=1e-4, aux_learning_rate=1e-3,
                     clip_max_norm=1.0):
    """(net optimizer, aux optimizer), each ``torch.optim.Adam`` over one
    side of ``net_aux_partition(model)``. The net optimizer's parameter
    group carries ``clip_max_norm`` (0 or None: no clip), which
    :func:`train_step` applies before the net Adam step, as
    ``optax.chain(clip_by_global_norm, adam)`` does."""
    net, aux = net_aux_partition(model)
    opt_net = make_adam(net.values(), {"lr": learning_rate},
                        clip_max_norm=clip_max_norm)
    opt_aux = make_adam(aux.values(), {"lr": aux_learning_rate})
    return opt_net, opt_aux


def _params(opt):
    return [p for group in opt.param_groups for p in group["params"]]


def local_rows(batch, group=None):
    """This rank's rows of ``batch``, a global batch (a tensor or an array)
    split evenly over ``group``'s ranks (None: the default group) in rank
    order; ``batch`` itself on one process. Raises when the global batch
    does not divide by the world size: each rank's loss is a mean over its
    rows, and the mean over the ranks is the global one only for equal
    shares (JAX's trainer asserts the same, examples/train.py:70)."""
    group = active_group(group)
    if group is None:
        return batch
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if batch.shape[0] % world:
        raise ValueError(f"a global batch of {batch.shape[0]} does not "
                         f"divide over {world} ranks")
    n = batch.shape[0] // world
    return batch[rank * n:(rank + 1) * n]


def _noise(generator, group):
    if group is None:
        return generator
    return RankNoise(generator, dist.get_rank(group),
                     dist.get_world_size(group))


def set_guarded_grads(loss, params, clip_max_norm=None, group=None,
                      logged=()):
    """Each parameter's ``.grad``: d loss / d p (zero where p does not
    reach the loss), all zero if the loss or any gradient is not finite,
    then clipped to the global norm ``clip_max_norm`` as optax does. The
    gradients are slices of one flat tensor, so the guard and the clip are
    a few kernels and never wait for the device.

    With ``group`` (a process group; None: this process alone), one
    all-reduce sums the flat gradient, the loss and the ``logged`` 0-d
    tensors over its ranks, then divides them by the world size, before
    the guard and the clip: every rank takes the global gradient, its
    norm and the guard's decision. Returns [loss, *logged], detached (over
    a group, their means over the ranks)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    n = sum(p.numel() for p in params)
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for p, g in zip(params, grads)]
                     + [t.detach().reshape(1).to(params[0].dtype)
                        for t in (loss, *logged)])
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(flat, group=group)
        flat /= dist.get_world_size(group)
    flat, terms = flat[:n], flat[n:].clone()
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    ok = torch.isfinite(terms[0]) & torch.isfinite(flat).all()
    flat = torch.where(ok, flat, zero)
    if clip_max_norm:
        norm = torch.linalg.vector_norm(flat)
        flat = torch.where(norm < clip_max_norm, flat,
                           flat / norm * clip_max_norm)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)
    return list(terms.unbind())


def _net_and_aux_steps(model, opt_net, opt_aux, terms, group=None):
    """Steps 2-5 of the module's docstring after the RD loss. ``terms``:
    {"loss": the RD loss, and the other terms a step returns}; returns
    them and "aux_loss" as detached 0-d tensors (over ``group``, the means
    over its ranks)."""
    names = ["loss"] + [k for k in terms if k != "loss"]
    values = set_guarded_grads(terms["loss"], _params(opt_net),
                               opt_net.param_groups[0].get("clip_max_norm"),
                               group, [terms[k] for k in names[1:]])
    opt_net.step()
    opt_net.zero_grad(set_to_none=True)

    aux_loss, = set_guarded_grads(model.aux_loss(), _params(opt_aux),
                                  group=group)
    opt_aux.step()
    opt_aux.zero_grad(set_to_none=True)
    return {**dict(zip(names, values)), "aux_loss": aux_loss}


def _image_step(model, opt_net, opt_aux, batch, generator, lmbda, metric,
                group):
    model.train()
    out = model(batch, training=True, generator=_noise(generator, group))
    details = rate_distortion_loss(out, batch, lmbda=lmbda, metric=metric)
    return _net_and_aux_steps(model, opt_net, opt_aux, {
        "loss": details["loss"],
        "bpp_loss": details["bpp_loss"],
        "mse_loss": details.get("mse_loss", details[f"{metric}_loss"]),
    }, group)


def train_step(model, opt_net, opt_aux, batch, generator,
               lmbda: float = 1e-2, metric: str = "mse"):
    """One RD step and one aux step on ``batch`` [B, H, W, 3] (on the
    model's device; float in [0, 1]) on this process alone, whatever
    process group exists; ``generator`` (a ``torch.Generator`` on that
    device) draws the training noise; ``metric`` is "mse" or "ms-ssim", the
    reference's two recipes. Returns {"loss", "bpp_loss", "mse_loss" (the
    metric's distortion), "aux_loss"} as detached 0-d tensors on the
    device: reading them is the caller's synchronisation."""
    return _image_step(model, opt_net, opt_aux, batch, generator, lmbda,
                       metric, None)


def data_parallel_train_step(model, opt_net, opt_aux, batch, generator,
                             lmbda: float = 1e-2, metric: str = "mse",
                             group=None):
    """:func:`train_step` over the ranks of ``group`` (None: the default
    group, where one exists). Each rank passes its rows of one global
    batch split evenly in rank order (``local_rows``) and a generator in
    the same state as every other rank's; every rank ends the step with the
    parameters and optimizer state that :func:`train_step` gives on the
    whole batch from that generator state, up to float32 summation order,
    and returns the global means of its terms. With no group, or a world
    of 1, it is :func:`train_step`."""
    return _image_step(model, opt_net, opt_aux, batch, generator, lmbda,
                       metric, active_group(group))


def vbr_train_step(model, opt_net, opt_aux, batch, generator, s: int,
                   lmbda: float, group=None):
    """One stage-2 step of a VBR model at gain level ``s`` with the
    rate-distortion weight ``lmbda`` (the reference's recipe draws the
    level per step and takes ``VBR_LMBDAS[s]``); otherwise as
    :func:`data_parallel_train_step` with the "mse" metric. Returns
    {"loss", "bpp_loss", "mse_loss", "aux_loss", "s"} as 0-d tensors on the
    batch's device."""
    group = active_group(group)
    model.train()
    out = model(batch, training=True, generator=_noise(generator, group),
                stage=2, s=s)
    details = rate_distortion_loss(out, batch, lmbda=1.0)
    loss = lmbda * 255.0 ** 2 * details["mse_loss"] + details["bpp_loss"]
    result = _net_and_aux_steps(model, opt_net, opt_aux, {
        "loss": loss, "bpp_loss": details["bpp_loss"],
        "mse_loss": details["mse_loss"]}, group)
    result["s"] = torch.tensor(int(s), dtype=torch.int32, device=batch.device)
    return result


def video_train_step(model, opt_net, opt_aux, frames, generator,
                     lmbda: float = 1e-2, group=None):
    """One multi-frame RD step and one aux step of a video model on
    ``frames``, a list or tuple of [B, H, W, 3] (a GOP; the first frame is
    the keyframe; over a group, this rank's rows of each frame), on the
    model's device; otherwise as :func:`data_parallel_train_step`. Returns
    {"loss", "bpp_loss", "mse_loss", "aux_loss"} as detached 0-d tensors
    on the device."""
    group = active_group(group)
    model.train()
    frames = list(frames)
    out = model(frames, training=True, generator=_noise(generator, group))
    details = video_rate_distortion_loss(out, frames, lmbda=lmbda)
    return _net_and_aux_steps(model, opt_net, opt_aux, {
        "loss": details["loss"], "bpp_loss": details["bpp_loss"],
        "mse_loss": details["mse_loss"]}, group)


def pointcloud_train_step(model, opt_net, opt_aux, points, generator,
                          loss_type: str = "chamfer", lmbda: float = 1.0,
                          group=None):
    """One RD step and one aux step of a point-cloud codec on ``points``
    [B, N, 3] (on the model's device). ``loss_type``: "chamfer"
    (``ChamferPccRateDistortionLoss(lmbda)``, the PointNet family; over
    ``group`` as :func:`data_parallel_train_step`) or "hrtzxf2022"
    (``RateDistortionLossHrtzxf2022()`` at its default weights; ``lmbda``
    unused; one process only: a world over 1 raises). Returns {"loss",
    "aux_loss"} and those of "bpp_loss", "rec_loss", "chamfer_loss" the
    criterion gives, as detached 0-d tensors on the device."""
    group = active_group(group)
    if loss_type == "hrtzxf2022" and group is not None:
        raise ValueError("hrtzxf2022's loss holds |sum over the batch - "
                         "target|: its step runs on one process")
    criterion = (RateDistortionLossHrtzxf2022() if loss_type == "hrtzxf2022"
                 else ChamferPccRateDistortionLoss(lmbda=lmbda))
    model.train()
    out = model(points, training=True, generator=_noise(generator, group))
    details = criterion(out, points)
    terms = {"loss": details["loss"]}
    for k in ("bpp_loss", "rec_loss", "chamfer_loss"):
        if k in details:
            terms[k] = details[k]
    return _net_and_aux_steps(model, opt_net, opt_aux, terms, group)
