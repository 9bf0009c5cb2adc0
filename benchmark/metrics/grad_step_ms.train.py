"""Mean milliseconds of one AnimationTrainer.grad_step (CUDA events)."""


def read(rec):
    calls = rec.events.get("grad_step", [])
    return sum(calls) / len(calls) if calls else None
