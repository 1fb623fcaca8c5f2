"""Model zoo of the port (reference: ``repro.models``): the dense attention family."""
