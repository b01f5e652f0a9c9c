"""Host loop and data: the mean milliseconds the host takes to draw one
batch from the cached-latent pool and assemble it in pinned memory (the
benchmark's span around each batch's assembly), over the window."""


def read(m):
    spans = m["spans"].get("host_batch")
    return 1e3 * sum(spans) / len(spans) if spans else None
