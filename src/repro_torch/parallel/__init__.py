"""Device layouts: the hardware-axis split of the fleet sweep."""
