"""Models of the port: the paper's CNN (``cnn``), the decoder LM of the
dense / moe / vlm families (``lm`` on ``layers`` and ``moe``, configured
by ``config`` and dispatched by ``api``), and the conversion of the JAX
package's parameters (``convert``)."""
