"""Single-image codec for the checkerboard-GMM flagship: one CUDA graph per
direction (port of flashgmm_tpu/runtime/latency_codec.py,
``FastLatencyGmmCodec``).

At batch 1 the host's share of the batched codec's time is large: some
sixty kernel wrapper calls and hundreds of library and elementwise launches
a direction, each a few microseconds of Python and launch overhead over
kernels of about as long. The JAX class fuses each direction into one XLA program; here each
direction is one ``torch.cuda.CUDAGraph`` over the batched codec's own stage
functions (``FastCheckerboardGmmCodec._encode`` and ``decode_y_hat``), so a
replay launches the whole direction at once. Three graphs, as the JAX class
has three programs:

- encode: transforms, quantization, the z pass and both y passes;
- decode-y: the unpack of the packed streams, the z decode, h_s, both y
  passes and ``embed``, every stream-consuming step;
- g_s, kept out of the certified program: it reads the exact integer-valued
  y_hat and no coder state, so it cannot desynchronise a stream.

Decode-y reads one static input, the three passes in the batched codec's
packed layout (``FastCheckerboardGmmCodec.packed_layout``: one int32 buffer
of the u32 words). A ``decode`` parses the bytes into the batched codec's
pinned staging buffer, copies it once, without waiting, into that static
input, and replays; nothing else crosses between host and device but the
error flag's read.

Certification, as in the JAX class: the encode graph also packs the
encoder's streams into the same layout on the device (they have the
capacities ``from_bytes`` gives, zero-padded as the bytes are), and
``encode_certified`` copies that buffer on the device into decode-y's
static input and replays the same decode-y graph that ``decode()``
replays, then compares the decoded y_hat with the encoder's on the
device, together with the decoders' error flag. A stream overflow or a failed certificate falls back to the batched
codec's bytes, themselves certified through decode-y; if even that fails,
their digest is remembered in this instance (with a ``RuntimeWarning``) and
``decode()`` routes them through the batched codec's decoder.

No fallback hides the device: a capture or a replay that fails raises, and
the decoders' deferred error flag is read after every decode-y replay.
Each graph is keyed by its shapes (encode: the image's; decode-y: y_shape
and the three stream capacities, so an overflow file, whose layout has the
uncapped capacity ``from_bytes`` gives, gets a graph of its own; g_s:
y_shape) and built at its first use:
one eager run on a side stream (it builds the kernels, settles the
library's algorithm choices and allocates workspaces), then the capture of
a second run, into one memory pool that every graph of the codec shares.
Every tensor a graph reads or writes is a static input or lives in that
pool, so the addresses the bf16 conv's TMA descriptors freeze at capture
stay valid; the outputs of every graph stay referenced, so no later
capture reuses their memory.

On a CPU model the same functions run eagerly on the kernels' plain
versions. The bytes are the batched codec's ``to_bytes`` format at the same
lanes.

``_GraphedCodec`` is this machinery over any batched codec's passes;
``FastLatencyElicCodec`` (``runtime/latency_elic.py``) shares it.
"""

import hashlib
import warnings

import torch

from flashgmm_tpu_torch.ans import rans_kernels, rows_kernel
from flashgmm_tpu_torch.ops import conv_kernel

from .fast_codec import FastCheckerboardGmmCodec, StreamOverflow

# the kernel wrappers whose ``.launches`` a capture records, read through
# their modules so that a wrapper rebound there is the one counted
_WRAPPERS = ((rans_kernels, "encode_scan"), (rans_kernels, "encode_scan_gmm"),
             (rans_kernels, "decode_scan"), (rans_kernels, "decode_scan_gmm"),
             (rows_kernel, "gmm_softmax"), (conv_kernel, "conv2d_nhwc"),
             (conv_kernel, "conv2d_nhwc_bf16"))


def _launch_counts():
    return {name: getattr(module, name).launches for module, name in _WRAPPERS}


class _Graph:
    """``fn`` captured as one CUDA graph over static input buffers.

    ``inputs`` are the static device buffers, holding the first call's
    values; one eager run on a side stream comes first, then the capture
    into ``pool``. ``launches`` is what each kernel wrapper counted during the
    capture: the hand kernels every replay launches (the counters count
    Python calls, so a replay adds nothing to them)."""

    def __init__(self, fn, inputs, pool):
        self.inputs = inputs
        side = torch.cuda.Stream(device=inputs[0].device)
        side.wait_stream(torch.cuda.current_stream(inputs[0].device))
        with torch.cuda.stream(side):
            fn(*inputs)
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=side):
            self.outputs = fn(*inputs)
        self.launches = {k: v - before[k] for k, v in _launch_counts().items()}

    def __call__(self, copy_in, *values):
        """Copy ``values`` into the static inputs by ``copy_in(src, dst)``
        and replay; returns the static outputs, which the next replay
        overwrites."""
        for dst, src in zip(self.inputs, values):
            copy_in(src, dst)
        self.graph.replay()
        return self.outputs


class _GraphedCodec:
    """The single-image codecs' machinery over a batched codec
    (``self._batched``, a ``fast_codec._FastCodec``): the three directions'
    graphs in one pool, the certificate, the fallback and the decode of
    bytes. A codec gives its encode graph's passes, y_hat and packed
    streams (``_certifiable``)."""

    def __init__(self, batched):
        # the stage functions, the bytes and the certification's fallback
        self._batched = batched
        self.lanes = batched.lanes
        self.max_abs = batched.max_abs
        self.cap_divisor = batched.cap_divisor
        self.device = batched.device
        self._graphed = self.device.type == "cuda"
        self._graphs = {}  # (direction, shape key) -> _Graph
        self._pool = None
        # the decoders' deferred error flag, shared by the decoders of a
        # direction (they only ever write 1 to it)
        self._err = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._fallback_digests = set()

    # -- the three directions --------------------------------------------------

    def _run(self, direction, key, fn, values):
        """fn(*values): eagerly on a CPU model (and with ``_graphed`` off,
        host values first copied to the card), else by replaying the
        direction's graph for ``key`` (captured at its first use)."""
        with torch.inference_mode():
            if not self._graphed:
                return fn(*(v if v.device == self.device
                            else self._batched.copy_staged(v) for v in values))
            graph = self._graphs.get((direction, key))
            if graph is None:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = _Graph(fn, [v.to(self.device, copy=True)
                                    for v in values], self._pool)
                self._graphs[(direction, key)] = graph
            return graph(self._copy_in, *values)

    def _copy_in(self, src, dst):
        """A graph's input copy: from the host (the pinned staging buffer)
        by ``copy_staged``, which records when it is done; on the device,
        a device copy."""
        if src.device.type == "cpu":
            self._batched.copy_staged(src, dst)
        else:
            dst.copy_(src)

    def _certifiable(self, x):
        """The encode graph's (passes in byte order, y_hat, the passes in
        the packed layout)."""
        raise NotImplementedError

    def _decode_y_packed(self, packed, y_shape, caps):
        """Decode-y graph over the passes in the packed layout of stream
        capacities ``caps`` (a pinned host buffer from the batched codec's
        ``pack``, or a device one): y_hat. The decoders' error flag is
        zeroed inside the graph; read ``self._err`` after it."""
        y_shape = tuple(y_shape)

        def decode_y(buf):
            self._err.zero_()
            return self._batched.decode_y_hat(self._batched.unpack(buf, caps),
                                              y_shape, err=self._err)

        return self._run("decode_y", (y_shape, tuple(caps)), decode_y,
                         [packed])

    def _decode_y(self, passes, y_shape):
        """The decode-y graph over PassStreams in byte order, packed on the
        device first: y_hat."""
        caps = tuple(p.stream.shape[0] for p in passes)
        with torch.inference_mode():
            packed = self._batched.pack_device(passes)
        return self._decode_y_packed(packed, y_shape, caps)

    def _passes(self, streams):
        """The batched codec's streams as PassStreams in byte order."""
        return self._batched._passes(streams)

    def _gs(self, y_hat):
        """g_s graph: x_hat clamped to [0, 1]."""
        b = self._batched
        return self._run(
            "g_s", tuple(y_hat.shape),
            lambda y: torch.clamp(b._transform(b._g_s, y), 0.0, 1.0), [y_hat])

    def _check_err(self):
        """Raise if a decoder of the last decode-y replay read past its
        stream (waits for the device)."""
        if int(self._err.item()):
            raise RuntimeError("latency decode: a stream was read past its "
                               "end (desynchronised or truncated stream)")

    @staticmethod
    def _cmp(a, b):
        """The certificate's comparison, on the device."""
        return (a == b).all()

    # -- certification ---------------------------------------------------------

    def _certificate(self, packed, y_shape, caps, y_hat):
        """Replay decode-y on the packed passes: a device bool, true iff it
        reproduced ``y_hat`` exactly and no decoder read past its stream."""
        y_dec = self._decode_y_packed(packed, y_shape, caps)
        return self._cmp(y_dec, y_hat) & (self._err == 0).all()

    @torch.inference_mode()
    def encode_certified(self, x):
        """Encode x [B, H, W, 3] (float in [0, 1]; the codec is for one
        image, B = 1) and certify the bytes against the decode-y graph.
        Returns (bytes, y_shape). The bytes always decode by ``decode()``:
        either they passed certification, or they are the batched codec's
        (certified too, or remembered and routed through its decoder)."""
        x = x.to(self.device, torch.float32)
        passes, y_hat, packed = self._certifiable(x)
        y_shape = tuple(y_hat.shape)
        # the encoder's streams always have the capacities from_bytes gives
        # (both from stream_capacities' rule), zero-padded as the bytes are,
        # so decode-y reads their packed buffer as it reads the bytes'
        caps = tuple(p.stream.shape[0] for p in passes)
        ok = self._certificate(packed, y_shape, caps, y_hat)
        try:
            data = self._batched._bytes_of(passes)
        except StreamOverflow:
            return self._encode_fallback(x, y_shape)
        if bool(ok):
            return data, y_shape
        return self._encode_fallback(x, y_shape)

    def _encode_fallback(self, x, y_shape):
        """The batched codec's bytes (its own overflow handling included),
        cross-certified through the decode-y graph; if that fails too, their
        digest is remembered and ``decode()`` routes them to the batched
        codec's decoder."""
        data, enc = self._batched.encode_to_bytes(x)
        host, caps = self._batched.pack(data, y_shape)
        if not bool(self._certificate(host, y_shape, caps, enc["y_hat"])):
            self._fallback_digests.add(hashlib.sha256(data).hexdigest())
            # the digest memory is per instance: another process must decode
            # these bytes with the batched codec's decode_bytes
            name = type(self._batched).__name__
            warnings.warn(
                "latency-codec certification and cross-certification both "
                "failed; returning batched-codec bytes routed via in-memory "
                f"digest. Decode these bytes in other processes with "
                f"{name}.decode_bytes.", RuntimeWarning)
        return data, y_shape

    # -- bytes and decode ------------------------------------------------------

    def stream_capacities(self, y_shape):
        """The batched codec's stream lengths for latent y_shape."""
        return self._batched.stream_capacities(y_shape)

    def from_bytes(self, data: bytes, y_shape):
        """Parse ``encode_certified`` bytes into the batched codec's streams
        on the device, unpacked (an overflow file gets the uncapped
        capacity); ``decode`` reads the packed layout instead."""
        return self._batched.from_bytes(data, y_shape)

    @torch.inference_mode()
    def decode(self, data: bytes, y_shape):
        """Bytes -> x_hat [1, H, W, 3] in [0, 1]: the bytes packed into the
        pinned staging buffer, one copy into the decode-y graph's input,
        the decode-y graph, then the g_s graph; raises if a stream was read
        past its end. Bytes that failed cross-certification in this
        instance go through the batched codec's decoder."""
        y_shape = tuple(y_shape)
        if self._fallback_digests and \
                hashlib.sha256(data).hexdigest() in self._fallback_digests:
            return self._batched.decode_bytes(data, y_shape)
        host, caps = self._batched.pack(data, y_shape)
        y_hat = self._decode_y_packed(host, y_shape, caps)
        x_hat = self._gs(y_hat)
        self._check_err()
        return x_hat.clone()


class FastLatencyGmmCodec(_GraphedCodec):
    """One-graph encode / one-graph decode around a
    Cheng2020AnchorCheckerboardGMMv2 (run ``model.update()`` first), on the
    model's device.

    ``kernel_transforms=True`` sends the bf16 transforms' eligible convs
    through the bf16 conv kernel, as in ``FastCheckerboardGmmCodec`` (the
    reference's ``FLASHGMM_PALLAS_CONV_TRANSFORMS``)."""

    def __init__(self, model, lanes: int = 1024, max_abs: int = 47,
                 cap_divisor: int = 4, bf16_transforms: bool = True,
                 kernel_transforms: bool = False):
        super().__init__(FastCheckerboardGmmCodec(
            model, lanes=lanes, max_abs=max_abs, cap_divisor=cap_divisor,
            bf16_transforms=bf16_transforms,
            kernel_transforms=kernel_transforms))

    def _encode_packed(self, x):
        """Encode graph: (z, y0, y1 PassStreams, sym0, sym1, y_hat, the
        three streams in the packed layout)."""
        b = self._batched

        def encode(x_):
            out = b._encode(x_, self.cap_divisor)
            return out + (b.pack_device(out[:3]),)

        return self._run("encode", tuple(x.shape), encode, [x])

    def _encode(self, x):
        """The encode graph's (z, y0, y1 PassStreams, sym0, sym1, y_hat)."""
        return self._encode_packed(x)[:6]

    def _certifiable(self, x):
        out = self._encode_packed(x)
        return out[:3], out[5], out[6]
