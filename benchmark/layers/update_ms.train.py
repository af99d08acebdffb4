"""Mean device milliseconds of an iteration's update (its minibatch steps
and the end phase) in the window, from CUDA events at the trainer's phase
boundaries."""


def read(r):
    if not r.phases:
        return None
    return sum(p[1] for p in r.phases) / len(r.phases)
