"""The runtime: chaos plans, the fault-tolerant supervisor, the straggler and
skew loop and the elastic shrink (in one process), and the multi-process
half: heartbeats and the liveness watchdog (``watchdog.py``) and the
respawn driver (``multiprocess.py``)."""
