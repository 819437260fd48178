from .fast_codec import FastCheckerboardGmmCodec, PassStream, StreamOverflow
from .latency_codec import FastLatencyGmmCodec

__all__ = ["FastCheckerboardGmmCodec", "FastLatencyGmmCodec", "PassStream",
           "StreamOverflow"]
