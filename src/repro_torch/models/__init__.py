"""Models of the port: the paper's CNN (``cnn``) and the conversion of
the JAX package's parameters (``convert``)."""
