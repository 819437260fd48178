from .fast_codec import FastCheckerboardGmmCodec, PassStream, StreamOverflow
from .fast_elic import FastElicGmmCodec
from .latency_codec import FastLatencyGmmCodec
from .latency_elic import FastLatencyElicCodec

__all__ = ["FastCheckerboardGmmCodec", "FastElicGmmCodec",
           "FastLatencyElicCodec", "FastLatencyGmmCodec", "PassStream",
           "StreamOverflow"]
