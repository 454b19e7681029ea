"""Models of the port: the DiT backbone, the CFM sampler and the Vocos vocoder."""
