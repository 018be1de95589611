"""The training CLI on a real dataset under ``torch.distributed.run``: two
gloo ranks (``--mesh_data 2``), each reading, decoding and collating only
its own sample of each micro-batch (`train.loop.rank_real_batches`),
against the one process that reads the whole batch of 2 (`real_batches`),
on `scripts/make_smoke_fixtures.py`'s training mixture (its mp4s decoded
with ``cv2``; skipped without it). The samples' lengths differ, so a
rank's own length bucket is often below the whole micro-batch's, which the
ranks agree on through the loader's exchange."""

import os
import sys

import pytest
import torch

from mmduet_tpu_torch.train import loop as tloop
from test_torch_train_mesh import METRICS, _close, _finish, _log, _start

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["--tiny_random", "--device", "cpu", "--seq_len", "512", "--grad_accum_steps", "2",
       "--num_epochs", "2", "--logging_steps", "1", "--save_steps", "0",
       "--dataloader_num_workers", "2"]


@pytest.fixture(scope="module")
def mixture(tmp_path_factory):
    pytest.importorskip("cv2")  # decodes the fixtures' mp4s
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_smoke_fixtures

    d = str(tmp_path_factory.mktemp("fixtures"))
    make_smoke_fixtures.main(d)
    return os.path.join(d, "train_mixture.json")


def test_ranks_reading_their_own_samples_match_the_one_process(mixture, tmp_path):
    """The same steps, the same losses to 1e-4 and the same ``pad_frac``
    (the whole batch's real and padded tokens, logged by rank 0)."""
    one, two = tmp_path / "one", tmp_path / "two"
    proc = _start(2, "-m", "mmduet_tpu_torch.train.loop", *CLI, "--dataset_config", mixture,
                  "--mesh_data", "2", "--dist_backend", "gloo", "--output_dir", str(two))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the launched ranks (OMP_NUM_THREADS=1)
    try:
        tloop.main(CLI + ["--dataset_config", mixture, "--per_device_batch_size", "2",
                          "--output_dir", str(one)])
    finally:
        torch.set_num_threads(threads)
    _finish(proc)
    got, want = _log(two), _log(one)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in METRICS:
            _close(g[k], w[k], atol=1e-4, rtol=1e-4)
        assert g["pad_frac"] == w["pad_frac"] > 0
