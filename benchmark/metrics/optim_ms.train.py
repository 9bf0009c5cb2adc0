"""Mean milliseconds of one AnimationTrainer.apply_step (CUDA events): the
gradient mean across ranks, the clip and the masked AdamW update.  On
several ranks each step's least time over the ranks: the rank that
reaches the exchange last waits for no other."""


def read(rec):
    calls = rec.events.get("apply_step", [])
    return sum(calls) / len(calls) if calls else None
