"""Training state, train step and fault tolerance (port of
`repro.distributed`)."""
