"""Feature recommender (counterpart of ``anovos_tpu/feature_recommender``).

Semantic search over a feature corpus.  The embedding backend prefers
sentence-transformers (``all-mpnet-base-v2``, the reference's model) when
its weights are on the machine, and otherwise takes the TF-IDF character
n-gram vectorizer (``FR_BACKEND=tfidf``, the fallback of ``auto``) or the
seeded hashed projection (``FR_BACKEND=hashed``): the same API, no
download.  Text preparation, the encoders and the ranking run on the
host; the cosine similarity matrix is a float64 product on the runtime's
device.
"""
