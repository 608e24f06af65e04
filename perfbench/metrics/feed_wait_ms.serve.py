"""Host milliseconds a serving batch that ``Detector.detect_stream``
spends waiting for the feed thread's assembled batch
(``mvx.serve.feed_wait``) once the stream runs: 0 when the host feed
keeps ahead of the card.  The window's first wait is left out: the
stream starts inside the window, so the feed thread then assembles the
first batch while the card has nothing to run (the pipeline's fill)."""
from perfbench.metrics._spans import ranges


def read(ctx):
    waits = ranges(ctx, "mvx.serve.feed_wait")[1:]
    if not waits:
        return None
    return sum(e - s for s, e in waits) * 1e3 / len(waits)
