"""Generation (`models/mmduet.py` `decode_loop`, through `_generate_batch`):
tokens served over the harness's seconds inside the batched decodes, in
the window before the traced slice (each decode ends in the host's read of
its tokens)."""


def read(run):
    calls = [c for c in run.unsliced() if c.kind in ("prefill", "step")]
    tokens = sum(c.lm_rows for c in calls)
    seconds = sum(c.seconds for c in calls)
    if not tokens or not seconds:
        return None
    return tokens / seconds
