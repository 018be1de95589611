"""Engine (`infer/batch_engine.py`, `_dispatch_sched`): milliseconds of
the harness's clock inside the batched dispatches (each ends in the host's
read of the probabilities) per frame fed, rolled-back frames each time
they are fed, in the window before the traced slice."""


def read(run):
    calls = [c for c in run.unsliced() if c.kind == "dispatch"]
    frames = sum(c.scored for c in calls)
    if not frames:
        return None
    return 1e3 * sum(c.seconds for c in calls) / frames
