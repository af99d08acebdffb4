"""Mean device milliseconds of an iteration's rollout and GAE in the
window, from CUDA events at the trainer's phase boundaries."""


def read(r):
    if not r.phases:
        return None
    return sum(p[0] for p in r.phases) / len(r.phases)
