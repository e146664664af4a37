from .svc_mia import RBFSVC, SVC_MIA, collect_prob, svc_mia_from_probs

__all__ = ["RBFSVC", "SVC_MIA", "collect_prob", "svc_mia_from_probs"]
