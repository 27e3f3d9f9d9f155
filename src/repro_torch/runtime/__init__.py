"""Step builders (training, prefill, decode), the fault-tolerant trainer
and the fault-tolerance pieces the fleet sweep uses."""
