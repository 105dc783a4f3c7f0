"""The training data of the port: the deterministic synthetic LM stream
(``pipeline.SyntheticLM``)."""
