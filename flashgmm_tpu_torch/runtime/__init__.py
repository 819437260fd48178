from .fast_codec import FastCheckerboardGmmCodec, PassStream, StreamOverflow

__all__ = ["FastCheckerboardGmmCodec", "PassStream", "StreamOverflow"]
