"""Distribution utilities: logical-axis sharding rules, tensors split over a
mesh, collectives, and the int8 error-feedback mean.

``sharding``     maps model-declared logical axis names ("embed", "ffn",
                 "batch", ...) onto mesh axes ("pod", "data", "model") by
                 the JAX package's rules, and splits a tensor by such a spec
                 into one block a mesh position (``shard`` / ``unshard``);
``collectives``  sums, maxima, concatenations and any other reduce over
                 mesh axes, driven by one process (``launch/mesh.py``);
``compress``     the int8 error-feedback gradient mean for slow links.
"""
