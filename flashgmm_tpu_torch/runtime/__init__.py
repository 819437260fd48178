from .fast_codec import (FastCheckerboardGmmCodec, FastCheckerboardGsmCodec,
                         PassStream, StreamOverflow)
from .fast_elic import FastElicGmmCodec
from .latency_codec import FastLatencyGmmCodec
from .latency_elic import FastLatencyElicCodec

__all__ = ["FastCheckerboardGmmCodec", "FastCheckerboardGsmCodec",
           "FastElicGmmCodec", "FastLatencyElicCodec", "FastLatencyGmmCodec",
           "PassStream", "StreamOverflow"]
