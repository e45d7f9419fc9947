from repro_torch.data.synthetic import ClusterData, TokenStream, make_classification_task

__all__ = ["ClusterData", "TokenStream", "make_classification_task"]
