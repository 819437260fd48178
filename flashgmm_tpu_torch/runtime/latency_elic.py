"""Single-image codec for Elic2022GMM: one CUDA graph per direction (port
of flashgmm_tpu/runtime/latency_elic.py, ``FastLatencyElicCodec``).

The batched ``FastElicGmmCodec`` launches some two hundred kernels and
library calls a direction at batch 1 (five groups, each a channel context,
two spatial contexts, two aggregation networks and two coder passes), each
paying its host time. As ``FastLatencyGmmCodec`` does for the flagship,
each direction is one ``torch.cuda.CUDAGraph`` over the batched codec's own
stage functions, with the same machinery (``latency_codec._GraphedCodec``):

- encode: transforms, quantization, the z pass and all ten GMM passes, and
  the eleven streams packed on the device;
- decode-y: the unpack of the packed streams, the z decode, h_s, each
  group's channel context, spatial contexts, aggregation networks and
  passes, and the embed;
- g_s.

``encode_certified`` replays decode-y on the encoder's packed streams and
compares y_hat on the device; a mismatch, the decoders' error flag or a
``StreamOverflow`` falls back to the batched codec's bytes (the
reference's routing, :185-245), and any other capture or replay error
raises. ``decode_bytes`` decodes bytes through the decode-y and g_s
graphs. On a CPU model the same functions run eagerly. The bytes are the
batched codec's ``to_bytes`` format at the same lanes.
"""

from .fast_elic import FastElicGmmCodec
from .latency_codec import _GraphedCodec


class FastLatencyElicCodec(_GraphedCodec):
    """One-graph encode / one-graph decode around an Elic2022GMM (run
    ``model.update()`` first), on the model's device. Defaults are the JAX
    class's (lanes=512, max_abs=47, cap_divisor=1);
    ``kernel_transforms=True`` as in ``FastElicGmmCodec``."""

    def __init__(self, model, lanes: int = 512, max_abs: int = 47,
                 cap_divisor: int = 1, bf16_transforms: bool = True,
                 kernel_transforms: bool = False):
        super().__init__(FastElicGmmCodec(
            model, lanes=lanes, max_abs=max_abs, cap_divisor=cap_divisor,
            bf16_transforms=bf16_transforms,
            kernel_transforms=kernel_transforms))

    def _encode_packed(self, x):
        """Encode graph: (the eleven PassStreams, the symbols of each pass,
        y_hat, the streams in the packed layout)."""
        b = self._batched

        def encode(x_):
            streams, syms, y_hat = b._encode(x_, self.cap_divisor)
            return streams, syms, y_hat, b.pack_device(streams)

        return self._run("encode", tuple(x.shape), encode, [x])

    def _certifiable(self, x):
        streams, _, y_hat, packed = self._encode_packed(x)
        return tuple(streams), y_hat, packed

    def decode_bytes(self, data: bytes, y_shape):
        """Bytes -> x_hat [1, H, W, 3] in [0, 1] (``decode``)."""
        return self.decode(data, y_shape)
