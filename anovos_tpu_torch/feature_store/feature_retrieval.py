"""Historical feature retrieval demo (counterpart of
``anovos_tpu/feature_store/feature_retrieval.py``).

Pulls point-in-time-correct features back out of a Feast repo generated by
``feast_exporter``, the round-trip proof that the exported repo is usable.
``feast`` is imported only when a retrieval runs, so the module imports
where feast is absent; a retrieval there raises ImportError.
"""

from __future__ import annotations

import logging
import sys
from datetime import datetime

import pandas as pd

logger = logging.getLogger(__name__)

DEMO_ENTITY_IDS = [
    "27a", "30a", "475a", "965a", "1678a",
    "1698a", "1807a", "1951a", "2041a", "2215a",
]

DEMO_FEATURES = [
    "income_view:income",
    "income_view:latent_0",
    "income_view:latent_1",
    "income_view:latent_2",
    "income_view:latent_3",
]


def _require_feast():
    try:
        import feast
    except ImportError as exc:  # pragma: no cover - feast not in the image
        raise ImportError(
            "feast is required for feature retrieval; install it or use the "
            "generated repo from another environment"
        ) from exc
    return feast


def build_entity_frame(entity_ids=None, entity_name: str = "ifa") -> pd.DataFrame:
    """Entity frame for a point-in-time join.

    Feast's ``get_historical_features`` requires the timestamp column to be
    named exactly ``event_timestamp`` (an ``event_time`` frame
    only works on old feast releases).
    """
    ids = list(entity_ids if entity_ids is not None else DEMO_ENTITY_IDS)
    now = datetime.now()
    return pd.DataFrame({entity_name: ids, "event_timestamp": [now] * len(ids)})


def retrieve_historical_features(
    repo_path: str,
    entity_df: pd.DataFrame,
    features=None,
    feature_service: str | None = None,
) -> pd.DataFrame:
    """Point-in-time-correct feature frame from a Feast repo.

    Either an explicit ``features`` list or a named ``feature_service``
    selects the columns.
    """
    if features is None and feature_service is None:
        raise ValueError("provide either a features list or a feature_service name")
    feast = _require_feast()
    fs = feast.FeatureStore(repo_path=repo_path)
    if feature_service is not None:
        features = fs.get_feature_service(feature_service)
    return fs.get_historical_features(entity_df=entity_df, features=features).to_df()


def retrieve_historical_feature_demo(repo_path: str) -> None:
    """End-to-end demo against the exporter's income repo."""
    entity_df = build_entity_frame()
    by_list = retrieve_historical_features(repo_path, entity_df, features=DEMO_FEATURES)
    logger.info(by_list.head())
    by_service = retrieve_historical_features(
        repo_path, entity_df, feature_service="income_feature_service"
    )
    logger.info(by_service.head())


if __name__ == "__main__":
    # entrypoint-only root-logger setup so the demo's logger.info output
    # (the .head() frames) is actually visible on the console
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if len(sys.argv) < 2:
        print("Please, provide a path to anovos feature repo!")
        sys.exit(1)
    retrieve_historical_feature_demo(repo_path=sys.argv[1])
