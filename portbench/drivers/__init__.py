"""One driver per engine of the port; a configuration names its driver."""
