from .generators import community_graph, directed_variant
