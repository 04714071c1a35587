"""The in-process runtime: chaos plans, the fault-tolerant supervisor, the
straggler and skew loop, and the elastic shrink."""
