"""Runtime helpers of the port: the typed env registry and device
resolution."""
