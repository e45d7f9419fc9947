from repro_torch.data.synthetic import ClusterData, make_classification_task

__all__ = ["ClusterData", "make_classification_task"]
