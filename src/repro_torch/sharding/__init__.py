"""The distribution layer (the port of ``repro.sharding``): the ambient
mesh (``context``) and the partition rules (``partition``)."""
