"""Training of the port: optimizers, train state, train step and loop."""
