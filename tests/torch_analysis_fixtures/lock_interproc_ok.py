# ctlint fixture: clean twin of lock_interproc_bad.py — the same
# helpers exist, but every blocking/syncing call happens AFTER the
# critical section.  NEVER imported.
import threading
import time


class Daemon:
    def __init__(self):
        self._map_lock = threading.Lock()
        self._dirty = False

    def tick(self):
        with self._map_lock:
            dirty = self._dirty
            self._dirty = False
        if dirty:
            self.flush()

    def flush(self):
        time.sleep(0.1)

    def launch(self, out):
        with self._map_lock:
            self._dirty = True
        self.finish(out)

    def finish(self, out):
        import torch

        torch.cuda.synchronize()
