"""peer_mb (parallel.sharding): the bytes a call of the split render
function copies from one card to another, in and out (the program's
``sharding.call`` span, attribute ``peer_bytes``), in MB (1e6 bytes),
mean over the window's calls. A count from shapes: at 8K 10-bit 4:2:0,
batch 4 over four cards, 597.1968. A program without the span reads
None."""

from benchmark_torch.spans import window


def read(run):
    calls = [r for r in window(run, "sharding.call") or ()
             if "peer_bytes" in r.attrs]
    if not calls:
        return None
    return sum(r.attrs["peer_bytes"] for r in calls) / len(calls) * 1e-6
