"""Bad: broad handlers that make failures vanish."""


def read_cache(path):
    try:
        with open(path) as f:
            return f.read()
    except Exception:
        pass


def poll(q):
    while True:
        try:
            return q.get_nowait()
        except:  # noqa: E722
            continue
