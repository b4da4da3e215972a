"""Good: narrow handlers, and broad ones that re-raise or record."""


def read_cache(path):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        pass  # narrow: the one expected failure; absence IS the answer


def guarded(fn, log):
    try:
        return fn()
    except Exception as e:
        log.append(e)
        raise


def fallback(fn):
    try:
        return fn()
    except Exception:
        return None
