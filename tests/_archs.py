"""Architecture ids the port has and the JAX reference package lacks:
tests that hold the port to the reference run over the reference's ids,
which are the port's less these."""
PORT_ONLY = ("zamba2-7b",)
