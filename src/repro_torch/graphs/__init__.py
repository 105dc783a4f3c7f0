from .generators import (community_graph, erdos_renyi, sensor_graph,
                         directed_variant, edge_perturbation,
                         evolving_erdos_renyi, real_graph_standin,
                         weight_jitter, GRAPHS)
