"""Mean ms a window step waited for its next batch, from the trainer's
own history (``Trainer.history``'s ``feed_wait_s``, averaged over each
logged span of steps)."""


def read(run):
    waits = run.get("feed_wait_s") or []
    if run.get("kind") != "train" or not waits:
        return None
    return sum(waits) / len(waits) * 1e3
