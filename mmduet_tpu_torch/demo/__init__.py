from .live import LiveInferForDemo
