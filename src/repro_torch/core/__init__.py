"""Device index, search loop, PQ, graph build and chunk layout."""
