"""Vision and admission (`infer/state.py` `staged_visual_encode`,
`models/siglip.py`): milliseconds of the harness's clock inside `_admit`
per frame admitted, over the admissions of the traced slice, where each
ends in a sync (elsewhere the tower's launches would still be running)."""


def read(run):
    calls = [c for c in run.sliced() if c.kind == "encode"]
    frames = sum(c.frames for c in calls)
    if not frames:
        return None
    return 1e3 * sum(c.seconds for c in calls) / frames
