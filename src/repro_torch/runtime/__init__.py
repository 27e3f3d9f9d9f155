"""Serving step builders (the train step waits for the training slice)."""
