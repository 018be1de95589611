"""Engine (the rollback after a trigger): frames scored over frames fed.
A trigger rolls back the frames of its chunk after the trigger frame, and
they are fed again."""


def read(run):
    if not run.frames_fed:
        return None
    return 100.0 * run.frames_scored / run.frames_fed
