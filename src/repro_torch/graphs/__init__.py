from repro_torch.graphs.graph import (PaddedGraph, bucket_pad, build_graph,
                                      canonical_edges, edge_gather, to_csr,
                                      unique_edges)
