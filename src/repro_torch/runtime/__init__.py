"""Serving step builders, and the fault-tolerance pieces the fleet sweep
uses (the train step waits for the training slice)."""
