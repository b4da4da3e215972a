"""Good: error-capturing thread targets and Thread subclasses."""
import threading


def compute():
    return 42


def spawn(q):
    def worker():
        try:
            q.put(compute())
        except BaseException as e:  # forwarded; the consumer re-raises
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    return t


class Writer(threading.Thread):
    """Subclass style: run() captures, join-side re-raises via .error."""

    def __init__(self, job):
        super().__init__(daemon=True)
        self.job = job
        self.error = None

    def run(self):
        try:
            self.job()
        except BaseException as e:
            self.error = e
