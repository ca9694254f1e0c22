"""Tools of the port: measurement scripts run on a CUDA card, and the
capture writer, run on the host (see each module)."""
