"""Device search factory and the batching ServingEngine."""
