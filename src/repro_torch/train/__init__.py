"""Train step and gradient sync of the port (reference: ``repro.train``)."""
