# ctlint fixture: blocking + a wait for the card reached only THROUGH
# the call graph (two frames below the lock).  NEVER imported.  The
# torch twin of tests/analysis_fixtures/lock_interproc_bad.py.
import threading
import time


class Daemon:
    def __init__(self):
        self._map_lock = threading.Lock()

    # -- lock-blocking via the call graph -----------------------------

    def tick(self):
        with self._map_lock:
            self.refresh()

    def refresh(self):
        self.flush()

    def flush(self):
        time.sleep(0.1)

    # -- device-sync-under-lock via the call graph --------------------

    def launch_locked(self, out):
        with self._map_lock:
            self.finish(out)

    def finish(self, out):
        import torch

        torch.cuda.synchronize()
