"""How the benchmark builds each of the port's apps from a configuration
file: one module per app, found by the configuration's ``app`` name."""
