from .generators import community_graph
