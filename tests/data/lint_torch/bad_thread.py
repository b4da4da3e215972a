"""Bad: thread targets whose exceptions die with the daemon thread."""
import threading


def worker(q):
    q.put(1)


def spawn(q):
    t = threading.Thread(target=worker, args=(q,), daemon=True)
    t.start()
    return t


def spawn_lambda(q):
    t = threading.Thread(target=lambda: q.put(1))
    t.start()
    return t
