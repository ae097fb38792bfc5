"""Recommender models of the port (`recsys`) and their dense layers
(`layers`)."""
