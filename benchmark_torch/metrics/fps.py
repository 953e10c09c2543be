"""fps: frames delivered to the consumer in the window, over its length."""


def read(run):
    frames = sum(b.count for b in run.batches
                 if b.delivered is not None and b.delivered <= run.t_close)
    return frames / run.seconds if frames else None
