"""Render, host: the host ms of the program's `sdlt.render.write` span
(the images' JPEG files) in the traced render call."""


def read(m):
    t = m["trace"]
    if t is None:
        return None
    spans = [e - s for n, s, e in t.host if n == "sdlt.render.write"]
    return 1e3 * sum(spans) if spans else None
