"""The training steps on one device (port of make_train_state,
data_parallel_train_step, vbr_train_step and video_train_step,
flashgmm_tpu/parallel/train.py:15-150).

The JAX step shards its batch over a mesh; the port trains on one card, so
it has neither a mesh nor DDP. The order of the JAX step is kept:
1. the rate-distortion loss of the training forward (uniform noise from
   ``generator``) and its gradients for the "net" parameters;
2. the non-finite guard: if the loss or any gradient is not finite, every
   gradient becomes zero. The step is not skipped: like optax's Adam,
   ``torch.optim.Adam`` then moves the parameters by their decayed
   momentum and counts the step, because each gradient is a zero tensor,
   never ``None`` (Adam skips a parameter whose gradient is ``None``);
3. optax's ``clip_by_global_norm``: ``g`` if ``||g|| < max``, else
   ``g / ||g|| * max`` (``torch.nn.utils.clip_grad_norm_`` divides by
   ``||g|| + 1e-6`` instead);
4. the net Adam step;
5. the aux loss of the updated model, its gradients for the quantiles
   alone, the same guard, the aux Adam step.

``vbr_train_step`` is the same step for the VBR models (``models/vbr.py``)
at one gain level: their stage-2 forward at ``s``, the loss ``lmbda * 255^2
* mse + bpp``. ``Gain`` is a "net" parameter that reaches no loss (the
forward detaches it), so its gradient is a zero tensor and Adam leaves it
where it is, as under the reference's ``stop_gradient``.

``video_train_step`` is the same step for the video model (ssf2020) on a
GOP: its forward over the frames, ``video_rate_distortion_loss``.

``pointcloud_train_step`` is the same step for the point-cloud codecs on
[B, N, 3] clouds: the chamfer RD loss (the PointNet family) or the
density-preserving one (hrtzxf2022, whose weights are its own; ``lmbda``
is unused there).

No library settings are pinned on the card: a training step's result
depends on no coded bytes, so it runs under the caller's (the trainer
leaves TF32 at PyTorch's defaults and lets cuDNN time its algorithms).
"""

import torch

from flashgmm_tpu_torch.losses import (ChamferPccRateDistortionLoss,
                                       RateDistortionLossHrtzxf2022,
                                       rate_distortion_loss,
                                       video_rate_distortion_loss)
from flashgmm_tpu_torch.optimizers.net_aux import make_adam, net_aux_partition


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


def set_guarded_grads(loss, params, clip_max_norm=None):
    """Each parameter's ``.grad``: d loss / d p (zero where p does not
    reach the loss), all zero if the loss or any gradient is not finite,
    then clipped to the global norm ``clip_max_norm`` as optax does. The
    gradients are slices of one flat tensor, so the guard and the clip are
    a few kernels and never wait for the device."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for p, g in zip(params, grads)])
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    ok = torch.isfinite(loss) & torch.isfinite(flat).all()
    flat = torch.where(ok, flat, zero)
    if clip_max_norm:
        norm = torch.linalg.vector_norm(flat)
        flat = torch.where(norm < clip_max_norm, flat,
                           flat / norm * clip_max_norm)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def _net_and_aux_steps(model, opt_net, opt_aux, loss):
    """Steps 2-5 of the module's docstring after the RD loss; returns the
    aux loss."""
    set_guarded_grads(loss, _params(opt_net),
                      opt_net.param_groups[0].get("clip_max_norm"))
    opt_net.step()
    opt_net.zero_grad(set_to_none=True)

    aux_loss = model.aux_loss()
    set_guarded_grads(aux_loss, _params(opt_aux))
    opt_aux.step()
    opt_aux.zero_grad(set_to_none=True)
    return aux_loss


def train_step(model, opt_net, opt_aux, batch, generator,
               lmbda: float = 1e-2, metric: str = "mse"):
    """One RD step and one aux step on ``batch`` [B, H, W, 3] (on the
    model's device; float in [0, 1]); ``generator`` (a ``torch.Generator``
    on that device) draws the training noise; ``metric`` is "mse" or
    "ms-ssim", the reference's two recipes. Returns {"loss", "bpp_loss",
    "mse_loss" (the metric's distortion), "aux_loss"} as detached 0-d
    tensors on the device: reading them is the caller's synchronisation."""
    model.train()
    out = model(batch, training=True, generator=generator)
    details = rate_distortion_loss(out, batch, lmbda=lmbda, metric=metric)
    loss = details["loss"]
    aux_loss = _net_and_aux_steps(model, opt_net, opt_aux, loss)
    return {
        "loss": loss.detach(),
        "bpp_loss": details["bpp_loss"].detach(),
        "mse_loss": details.get("mse_loss", details[f"{metric}_loss"]).detach(),
        "aux_loss": aux_loss.detach(),
    }


def vbr_train_step(model, opt_net, opt_aux, batch, generator, s: int,
                   lmbda: float):
    """One stage-2 step of a VBR model at gain level ``s`` with the
    rate-distortion weight ``lmbda`` (the reference's recipe draws the
    level per step and takes ``VBR_LMBDAS[s]``); otherwise as
    :func:`train_step` with the "mse" metric. Returns {"loss", "bpp_loss",
    "mse_loss", "aux_loss", "s"} as 0-d tensors on the batch's device."""
    model.train()
    out = model(batch, training=True, generator=generator, stage=2, s=s)
    details = rate_distortion_loss(out, batch, lmbda=1.0)
    loss = lmbda * 255.0 ** 2 * details["mse_loss"] + details["bpp_loss"]
    aux_loss = _net_and_aux_steps(model, opt_net, opt_aux, loss)
    return {
        "loss": loss.detach(),
        "bpp_loss": details["bpp_loss"].detach(),
        "mse_loss": details["mse_loss"].detach(),
        "aux_loss": aux_loss.detach(),
        "s": torch.tensor(int(s), dtype=torch.int32, device=batch.device),
    }


def video_train_step(model, opt_net, opt_aux, frames, generator,
                     lmbda: float = 1e-2):
    """One multi-frame RD step and one aux step of a video model on
    ``frames``, a list or tuple of [B, H, W, 3] (a GOP; the first frame is
    the keyframe), on the model's device; otherwise as :func:`train_step`.
    Returns {"loss", "bpp_loss", "mse_loss", "aux_loss"} as detached 0-d
    tensors on the device."""
    model.train()
    frames = list(frames)
    out = model(frames, training=True, generator=generator)
    details = video_rate_distortion_loss(out, frames, lmbda=lmbda)
    loss = details["loss"]
    aux_loss = _net_and_aux_steps(model, opt_net, opt_aux, loss)
    return {
        "loss": loss.detach(),
        "bpp_loss": details["bpp_loss"].detach(),
        "mse_loss": details["mse_loss"].detach(),
        "aux_loss": aux_loss.detach(),
    }


def pointcloud_train_step(model, opt_net, opt_aux, points, generator,
                          loss_type: str = "chamfer", lmbda: float = 1.0):
    """One RD step and one aux step of a point-cloud codec on ``points``
    [B, N, 3] (on the model's device). ``loss_type``: "chamfer"
    (``ChamferPccRateDistortionLoss(lmbda)``, the PointNet family) or
    "hrtzxf2022" (``RateDistortionLossHrtzxf2022()`` at its default
    weights; ``lmbda`` unused). Returns {"loss", "aux_loss"} and those of
    "bpp_loss", "rec_loss", "chamfer_loss" the criterion gives, as detached
    0-d tensors on the device."""
    criterion = (RateDistortionLossHrtzxf2022() if loss_type == "hrtzxf2022"
                 else ChamferPccRateDistortionLoss(lmbda=lmbda))
    model.train()
    out = model(points, training=True, generator=generator)
    details = criterion(out, points)
    loss = details["loss"]
    aux_loss = _net_and_aux_steps(model, opt_net, opt_aux, loss)
    result = {"loss": loss.detach(), "aux_loss": aux_loss.detach()}
    for k in ("bpp_loss", "rec_loss", "chamfer_loss"):
        if k in details:
            result[k] = details[k].detach()
    return result
