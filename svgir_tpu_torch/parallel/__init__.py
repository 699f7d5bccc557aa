"""The parallel paths on ``torch.distributed``: view data parallelism and
the sharded bake (``dp``), the Gaussian- and tile-row-sharded rasterizer
(``gshard``) and their differentiable collectives (``comm``)."""
