from .video import letterbox, decode_video, probe_video, build_metadata
from .eval_dataset import StreamingEvalDataset, EvalSample
