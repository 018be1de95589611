from .state import StreamState, ThresholdPolicy, pick_bucket, pad_chunk, DEFAULT_BUCKETS
from .engine import LiveInferEngine
from .batch_engine import BatchedStreamEngine, BatchedStreamScorer
