"""The port's inference CLI with one video that fails to decode on one
rank only, for the CLI tests of `tests/test_torch_tp_serving.py` and
`tests/test_torch_dp_serving.py` (not a pytest module itself).

Usage (from the repository root, ``PYTHONPATH`` holding it)::

    python -m torch.distributed.run --nproc_per_node N tests/torch_cli_worker.py RANK VIDEO ARGS...

On rank RANK, decoding the file named VIDEO raises, as a transient read
error on a shared filesystem would; everything else is ``python -m
mmduet_tpu_torch.eval.inference ARGS``. The tests import `failing` to make
the one process fail the same video, and `decoded` to read the ranks'
counts.
"""

import os
import sys

from mmduet_tpu_torch.data import eval_dataset
from mmduet_tpu_torch.eval import inference


def failing(decode, video: str, fails):
    """``decode`` (`data.video.decode_video`), raising OSError for the file
    named ``video`` wherever ``fails()`` is true."""
    def wrapped(path, *args, **kwargs):
        if os.path.basename(path) == video and fails():
            raise OSError(f"{path}: transient read error")
        return decode(path, *args, **kwargs)

    return wrapped



def decoded(stderr: str) -> dict:
    """{(d, m): (samples decoded, of how many)} from the ranks' last lines
    on stderr (`eval.inference._samples`)."""
    import re

    return {(int(d), int(m)): (int(k), int(n)) for d, m, k, n in re.findall(
        r"samples, rank \((\d+), (\d+)\): decoded (\d+) of (\d+);", stderr)}


if __name__ == "__main__":
    rank, video = sys.argv[1:3]
    eval_dataset.decode_video = failing(eval_dataset.decode_video, video,
                                        lambda: os.environ["RANK"] == rank)
    inference.main(sys.argv[3:])
