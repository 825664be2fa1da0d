#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``anovos_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. build: compile every CUDA kernel of the port from ``anovos_tpu_torch/ops/
   kernels/csrc`` (one nvcc a source for sm_90a, all at once, loaded with
   ctypes), print each kernel's registers and spills, the build seconds and
   the instructions a pair of the neighbour-count kernel's pair loop (its
   SASS, where the toolkit has ``cuobjdump``); then the host codec
   (``anovos_tpu_torch/shared/csrc/anovos_native.cpp``, g++ with zlib),
   printing the compiler, whether ``zlib.h`` is there and the build
   seconds.  Every Avro read and write, every string column's dictionary
   encoding and DBSCAN's default components below go through the codec;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the 4,000,000-row bench's shapes and at unaligned row counts (≡ 1, 2, 3 mod 4,
   1,333,333 among them; an all-masked column, a NaN cutoff row, a
   normal(1e5, 3) column whose first row is null), the moments kernel twice
   at every shape with bit-identical results; each kernel's time as 5
   repeats of 50 launches (min, median, max), warm and with L2 flushed
   before each launch, beside the plain version's time and the card's
   lower bound;
3. path: the income schema at 2,000,000 rows written as parquet and read
   back with ``read_dataset``, the eleven ``stats_generator`` measures,
   ``drift_stability.statistics`` (PSI/HD/JSD/KS, bin_size 10, no
   sampling) of the second half against the first, once to warm up and
   once timed, and ``stability_index_computation`` over three slices.
   Results are checked against float64 pandas/numpy references, and every
   kernel of this path must have been launched by this phase.  Phases
   6-8, 10a/b and 13-14 go on with the first 1,000,000 of these rows,
   written and read back the same way (``SUB_ROWS``);
4. geo kernels: the DBSCAN neighbour-count kernel equal to its plain version
   at the shapes of the JAX package's Pallas test and at its edges (every
   width 1-8; n = 1, below one source split, a query tile and a split ± 1,
   last splits ragged against the unroll; eps² = 0 on duplicated points,
   an eps beyond the set's diameter, the spacing-eps lattice; NaN,
   infinite and overflowing points and a non-finite eps², which take the
   literal form; calls at changing n), then at 100,000 points with its time
   (5 repeats of 50 launches), the plain version's and the card's lower
   bound;
5. geo path: a 500,000-row table of six Gaussian cities (σ = 0.3°) and 2%
   uniform noise, with a lat/lon pair (1% nulls), a precision-7 geohash of
   the same points and an id, written as parquet and read back with
   ``read_dataset``; ``geospatial_autodetection`` with the default knobs
   (the codec's union-find components on the host, no neighbour-count
   launch, each union-find call's labels checked equal to scipy's
   components of the same edges), the same call
   with ``ANOVOS_DBSCAN_GRID_SAMPLE=16384`` (one neighbour-count launch per
   eps, the batched device labeling) and ``generate_loc_charts_controller``.
   Then the kernels at the shapes and on the data this path gave them (the
   moments kernel on the lat/lon block, the neighbour-count kernel on the
   centred 16,384-point grid sample at every eps) against their plain
   versions, timed.  The neighbour counts at every eps and the DBSCAN
   labels of a seeded sample of 2 of the 35 combos are checked against
   float64 numpy/scipy (every combo's labels against the analyzer's
   frame), the k-means centers
   against a float64 Lloyd run from the same start, and every expected
   file must exist;
6. quality: on phase 3's 1,000,000-row Table, each step timed on the host clock ending
   in a device sync: ``concatenate_dataset`` of the Table and its first
   100,000 rows; the seven quality checks with ``config/configs_full.yaml``'s
   arguments in its order, each on the previous one's treated Table
   (outlier_detection fits on a 1,000,000-row sample, nullColumns imputes
   the median); ``invalidEntries_detection`` on a 1,000,000-row Table with
   1% auto-rule tokens in a string column; drift ``statistics`` with its
   sampling defaults (100,000 rows a side); ``recommend_type``; then a
   1,000,000-row frame read from parquet, its 100,000-row join side written
   and read back as avro, ``join_dataset`` (inner, on ``ifa``) and the
   joined Table written and read back as parquet, csv and avro.  Checked:
   exactly 100,000 duplicates, null rows, IDness and modes against pandas,
   each outlier bound within 1% of the float64 fence over all rows and its
   count against numpy, the imputed medians against numpy's lower median,
   the invalid counts against a Python reference of the auto rules, the
   sampled sides within 5 binomial sigma of 100,000 and their PSI below
   0.1, distinct counts against pandas, the join against ``pandas.merge``
   and every file read back equal; both B1 and B2 must have been launched;
7. association and the stats edges: on phase 3's 1,000,000-row Table, each step timed on
   the host clock ending in a device sync and its kernel launches counted:
   ``correlation_matrix`` with TF32 switched on globally around the call,
   ``IV_calculation`` and ``IG_calculation`` (label income, event '>50K',
   10 equal-frequency bins), ``variable_clustering`` on its 100,000-row
   sample, ``attribute_binning`` equal_range with 10 bins of every numeric
   column, ``monotonic_binning`` of age and hours-per-week,
   ``cat_to_num_transformer`` label encoding (the arguments of
   ``config/configs_full.yaml:105-138``), ``uniqueCount_computation`` exact
   and approximate (rsd 0.05); then the three moment measures on a numeric
   Table of 2^24 + 12,345 rows x 9 columns, which take the compensated
   moments.  Then B1 at this path's two new shapes (one 1,000,000-row
   column; the compensated moments' (2,313 x 65,536) chunk view).  Checked
   against float64 numpy/pandas: correlation within 1e-5; IV and IG equal
   to 4 decimals; clusters equal to the port's VarClus on a float64
   correlation of the same sample (RS_Ratio within 1e-3); bin ids and label
   codes exact; approximate distinct counts within 3 x rsd of exact with
   registers equal to the CPU's; the compensated moments within ten times
   PERF.md's compensated bands, the plain f32 error printed beside them;
   B1 must have been launched;
8. time series: phase 3's 1,000,000-row Table with the same synthesized rows' ``ifa``,
   ``dt_1`` and ``dt_2`` added (the ``configs_basic`` schema), each step
   timed on the host clock ending in a device sync: ``ts_preprocess`` with
   ``configs_basic.yaml``'s ``timeseries_analyzer`` arguments,
   ``ts_analyzer`` with ``configs_full.yaml``'s, ``aggregator`` at
   ``%Y-%m`` and ``%Y-%m-%d`` (all seven aggregates of the 9 numeric
   columns), ``window_aggregator`` rolling (window 3) and expanding (mean,
   min, max of age and fnlwgt) with and without ``partition_col
   ="workclass"``, ``lagged_ts`` (ts_diff in days), ``timeUnits_extraction
   (..., "all")``, the 16 boundary snaps and predicates, and
   ``apply_offset_table`` against a fixed transition table.  Checked
   against float64 pandas/numpy on all rows: dt_1 and dt_2 converted with
   ``pandas.to_datetime``'s seconds and no other column converted; every
   ``ts_*`` file (counts, min, max and median exact, means within 1e-4 +
   1e-5·|mean|, decomposition and ADF/KPSS from the same count series);
   aggregator sums, means and stddev within 1e-5 relative; windows and lags
   equal to pandas' rolling/expanding/shift; calendar fields equal to
   pandas ``.dt``; every returned tensor on the card; no kernel launched;
9. runner: ``anovos_tpu_torch.workflow.main`` on ``config/configs_basic.yaml``'s
   blocks (a copy, ``BASIC_CONFIG``), its input 250,000 synthesized rows of
   the full income schema as parquet and its join side every row's
   ifa/age/workclass as avro, in a working directory kept for phase 15,
   in the runner's default executor mode (``concurrent`` on a host with
   more than one CPU): read, join
   (inner, so all 250,000 rows go on), timestamp detection, the basic
   report (seven stats measures, seven quality checks, IV/IG, the charts
   and the HTML) and the final write, each block's wall from
   ``workflow.block_times()``, the schedule's summary and the peak device
   memory.  Then the kernels on the inputs the runner
   gave them (recorded as it ran), against their plain versions, timed.
   Checked against float64 pandas/numpy: every CSV and chart the basic
   report writes exists; the stats CSVs with phase 3's bands, skewness and
   kurtosis within 2e-3 + 2e-3·|x|; duplicates, null rows, null columns,
   IDness and modes exact; each outlier count inside the counts of fences
   1% off the float64 fence; invalid entries against the auto rules'
   reference; IV/IG equal to 4 decimals; every numeric ``freqDist_`` chart
   equal to a numpy digitize against the deciles the chart used, and every
   ``eventDist_`` chart's rates within 1e-6 of the label counts a bin or a
   category; dt_1 and dt_2 converted; the HTML's six tabs; the final
   dataset equal to the pandas inner join; no block failed; both B1 and B2
   launched by the runner;
10. transformers: (a) on phase 3's 1,000,000-row Table, each step timed on the host clock
   ending in a device sync with its kernel launches counted:
   ``config/configs_full.yaml``'s six transformer steps chained
   (feature_transformation sqrt, attribute_binning, outlier_categories,
   cat_to_num_supervised, IQR_standardization, PCA_latentFeatures), then
   z_standardization, normalization, boxcox_transformation with the λ
   search, expression_parser on two expressions and fitted_state → JSON →
   from_state().apply for the 10 servable families; checked on all rows
   against float64 numpy/pandas: sqrt values and nulls, the keep sets
   against a pandas value_counts cumsum, the target rates equal to a
   pandas groupby mean at 4 decimals, median and IQR equal to numpy's
   'lower' quantiles, the z and min-max parameters in phase 3's bands,
   PCA's k, components and projections against float64 ``eigh``, each
   boxcox λ equal to the float64 KS argmin where the margin exceeds f32
   noise, the expressions, every served apply equal to its batch apply;
   (b) autoencoder_latentFeatures at n = 9, k = 4 with
   ``configs_segmentation_unsupervised``'s batch (256) on a 62,500-row
   sample (the config's 500,000 cut), AE_EPOCHS epochs: the validation MSE below the first epoch's and
   the mean predictor's, the model.npz round trip bit-equal, the card's
   latents equal a CPU forward, 3 Adam steps equal to the CPU's; (c) KNN,
   regression, MF and auto imputation on a 250,000-row table with 5%
   nulls in three columns, checked against float64 (KNN on seeded query
   rows whose donors f32 distances decide, the ridge by least squares),
   MF's observed-cell error, auto's output equal to its choice's, and its
   choice against the CPU port's on the same holdout of the first 100,000
   rows; (d) ``workflow.main`` on all of ``configs_full.yaml``
   (a copy, ``FULL_CONFIG``) over 150,000 synthesized rows in the
   default executor mode, its input and run kept for phase 15: the six
   intermediate datasets written, the final dataset equal to the same
   chain of direct calls, no block failed.  B1 must have been launched;
   B1 and B2 equal their plain versions on every input the phase gave
   them on the card;
11. the codec and the four configs no earlier phase runs: (a) an avro file
   of 250,000 rows of the full income schema written and read through
   the codec with deflate and with snappy, read back equal to the frame,
   and on its first 10,000 rows the codec timed beside the pure-Python
   record loops; (b) ``config/configs.yaml`` (a copy) through
   ``workflow.main`` on 100,000 income rows as parquet, concatenated with a
   second read (200,000 rows) and inner-joined with an avro side of one
   row per distinct ifa, each block's wall from ``workflow.block_times()``,
   then B1 and B2 against their plain versions on every input the runner
   gave them; checked: the joined dataset equal to the pandas concat and
   join, the stats CSVs in phase 3's bands, the duplicate check's final
   rows, the transformers' datasets, and drift_statistics degraded as the
   JAX runner degrades it (the source lacks the join's columns); (c)
   ``configs_time_series``, ``configs_geospatial`` (check-in schema as CSV,
   50,000 rows, six cities) and ``configs_mlflow`` (50,000 income rows,
   ``mlflow`` unimportable) and ``configs_feast`` (50,000 income rows)
   through ``workflow.main``, their files, the timestamp's conversion,
   the DBSCAN grid and their stats CSVs checked, configs_feast's final
   dataset one part with its two timestamp columns and its ``anovos.py``
   compiling and equal to the CPU port's for the same config, B1 and B2
   against their plain versions.  The walls of the steps the codec now
   runs in phases 3, 6, 8 and 9 are printed beside their walls before the
   codec;
12. geospatial transformers: 1,000,000 rows of phase 5's six-city points
   with a second location pair (half within 50 km, half uniform over the
   globe, 1% near-antipodal), an int id of 100,000 values, the same ids
   as strings and a weight, built in memory; each step timed on the host
   clock ending in a device sync: ``geo_format_latlon`` to radian,
   cartesian and geohash (precision 9), and to dms and back on the first
   250,000 rows; ``geo_format_cartesian`` and ``geo_format_geohash``
   back to dd; ``geohash_precision_control`` to 5; ``location_distance``
   of the three types in km; ``location_in_country`` approx US and exact
   against a 2,000-edge GeoJSON the phase writes (a MultiPolygon with a
   hole, two overlapping polygons); ``location_in_polygon`` with it;
   ``centroid`` global, by the int and by the string id;
   ``weighted_centroid`` and ``rog_calculation`` by the int id;
   ``reverse_geocoding`` on the bundled city table; then the CUDA-event
   time of four steps' device parts alone (geohash bits, Vincenty, the
   polygon test, the per-id centroid).  Checked against
   float64 numpy/pandas and the port's ``geo_utils``: radians and
   cartesian to f32 storage, the round trips, geohashes equal
   ``geohash_encode`` on 100,000 rows, distances in the CPU tests' bands
   away from the antipode (Vincenty on a 250,000-pair sample), polygon
   flags equal a float64 ray cast but within 1e-5° of an edge (counted),
   centroids and radii against a pandas groupby, reverse geocoding equal
   a float64 brute force but near ties (counted).  No kernel launches;
13. streaming: phase 3's 1,000,000-row frame written (timed apart) as 16 target parquet
   parts of 250,000 rows, each numeric column shifted by (0.25 + 0.01·⌊i/4⌋)
   σ, and 8 unshifted source parts; ``workflow.main`` on one
   ``streaming_analysis`` block over them in 250,000-row chunks (no
   ``input_dataset``): describe, quality_missing, quality_outlier (bounds
   fitted by ``outlier_detection`` on part 0) and drift (the source folder,
   ``configs_full.yaml``'s drift options), each pass's decode, fetch-wait
   and drain split printed.  Checked: (a) ``stream_describe.csv`` against
   float64 numpy (counts, min, max, nonzero exact, the moments in the CPU
   tests' bands, each quantile within one bin width); (b) missing and
   outlier counts exact; (c) ``stream_drift.csv`` and the drift model equal
   to the in-memory ``statistics`` of the same rows (metrics within 1e-4,
   the model files byte-equal); (d) peak device memory at most (high water
   + 2) × chunk rows × k × 5 B + 256 MB; (e) a describe killed after 5
   chunk commits and resumed equal to the uninterrupted one with fewer
   part decodes; (f) a quality_missing run with
   ``ANOVOS_TPU_CHAOS=corrupt@io:*part-00003.parquet:n=99`` quarantining
   that part (250,000 rows lost) and counting the other 15.  B1 and B2
   launch on the path and are held to their plain versions on part 0's
   chunk.
14. continuum: phase 13's 8 source parts hard-linked as the baseline
   days ``base-0000i.parquet`` and its 16 target parts as
   ``day-000ii.parquet`` (24 partitions of 250,000 rows, 19 columns, 9
   numeric), through ``anovos_tpu_torch.continuum.step`` with every
   column, phase 13's outlier model and a drift model fitted from
   ``base-*`` (method all, 10 bins, threshold 0.1), each step's decode,
   fold, fit, finalize, render and snapshot seconds printed: (a) the
   catch-up (24 folds, the model fitted with one re-decode of the 8
   baseline parts), (b) one new day shifted a further 1σ (one decode, one
   fold, its drift alert with the flight recorder's tail; its wall is the
   arrival-to-artifact lag), (c) a step with no arrival, (d) a corrupt
   day, quarantined with its alert, (e) two more days, a ``python -m
   anovos_tpu_torch.continuum step`` killed by a chaos fault after the
   first one's fold commit and another that resumes.  Checked: the stats
   CSV against float64 numpy over phase 13's values (counts, min, max,
   nonzero exact, the moments in phase 13's bands), the missing, outlier
   and categorical counts exact, the fitted binning model byte-equal to
   phase 13's streaming fit and its frequencies equal at f32, the
   cumulative drift frame within 1e-4 of phase 13's, day 0's HLL registers
   equal to the CPU's, the launches (B1 and B2 24 times in (a), once each
   in (b), none in (c) and (d)), no part with two fold commits after
   (e), and B1 and B2 against their plain versions on day 0's block.

15. the executor and the recommender: (a) the feature recommender on the
   whole shipped corpus (1,684 rows) under ``FR_BACKEND=tfidf`` and
   ``hashed``: every public function of the explorer and the mapper and
   ``sankey_visualization`` on the card, then on the CPU port, each call's
   wall printed, the results equal (scores within one unit of their 4th
   decimal) and the float64 cosine matrix of the grouped corpus' 1,433
   feature texts with themselves within 1e-12 of the CPU's; (b) configs_basic on phase 9's input and
   configs_full on 10d's again under ``ANOVOS_TPU_EXECUTOR=sequential``:
   every file, the HTML included, byte-equal to the concurrent runs', the
   same schedule and launch counts, each launch against its plain version
   on the inputs the runner gave it, both modes' schedule summaries (wall,
   serial, critical path, speedup), block walls and peak device memory
   printed; (c) configs_full on 50,000 rows in the concurrent mode with
   ``ANOVOS_TPU_CHAOS=hang@node:association_evaluator/IV_calculation`` and
   ``ANOVOS_TPU_NODE_TIMEOUT=10``: the node escalated, abandoned and
   degraded within its 25 s bound, every other node done, the report's
   first tab the Degraded Sections tab naming it.
16. the run record: (a) phase 9's run left ``obs/run_manifest.json``,
   naming every node of its schedule with a devprof entry each, its
   ``block_seconds`` equal to ``workflow.block_times()``; phase 9's
   scheduler wall printed beside its wall before the run record, and its
   per-node devprof
   split (device, dispatch, transfer, host seconds, h2d and d2h bytes) on
   a line of its own; (b) configs_basic on the first 100,000 of phase 9's
   rows twice under ``ANOVOS_TPU_EXECUTOR=sequential``, into two
   directories: the manifests' ``stable_view`` equal; (c) the same config
   through ``workflow.run`` on a written config file with
   ``ANOVOS_TPU_TRACE=1``, ``ANOVOS_TPU_DEVPROF=full`` and
   ``ANOVOS_PROFILE=<dir>`` in the default mode, with no runtime set, as
   ``python -m anovos_tpu_torch`` starts it.  Checked: the node spans
   of each lane of the Chrome trace sum to at most 1.10 x the scheduler
   wall + 0.05 s; every node's device + dispatch + transfer + host is at
   most its wall; each node that launched B1 or B2 (the launches
   attributed to nodes as they happen) has its devprof entry; the h2d bytes
   the manifest books are at least 5 bytes a cell of the two inputs
   (each column's values of 4 bytes or more and its 1-byte mask) and at
   most the bytes of the host-to-device copies in the profiler trace (the
   ops' own small uploads, bounds and lookup tables, are outside the
   manifest's count, as in the JAX package); the profiler trace holds B1's and B2's
   kernels as often as phase 15b launched them, each inside the range of
   a node that launched it; a report rendered over the run's output has
   the Run Timings tab.  Its split is printed like (a)'s.  Then a scheduler
   node that leaves a device sleep in flight, in each mode under
   ``ANOVOS_TPU_DEVPROF=full``: its drain books at least 0.8x the
   sleep's CUDA-event time, and at most the node's wall.  (c)'s file tree
   (``obs/`` left out) equals (b)'s, and phase 17 holds its runs to it.
17. the node cache (``ANOVOS_TPU_CACHE``), configs_basic on phase 16's
   100,000 rows in the default executor mode, each run in a directory of
   its own: (a) a populate run into a fresh store: 3 misses, B1 2 and B2 1
   launched, each held against its plain version on the inputs the runner
   gave it, the tree equal to phase 16 (c)'s; (b) a full hit: 0 misses,
   all 3 nodes restored, 0 launches of B1 and B2, the tree equal to (a)'s,
   its restore seconds and walls printed beside (a)'s; (c) the basic
   report's ``event_label`` edited: the join and ts detection hit, the
   report re-executes on the df version restored from the payload
   (uploaded at its first read), B1 2 and B2 1 launched and held against
   their plain versions, the tree equal to an uncached run of the edited
   config; (d) ``python -m anovos_tpu_torch`` with the cache at
   ``.anovos_cache``, sequential (each journal line written before the
   next node), killed by ``os._exit`` as the report node starts, then
   ``python -m anovos_tpu_torch ... --resume`` in the same directory with
   ``ANOVOS_TPU_CACHE`` unset, in the default mode: ``resumed_from`` 2,
   2 hits, 1 miss, the tree equal to (a)'s; (e) a full hit under
   ``ANOVOS_TPU_CACHE_MAX_BYTES`` at half the store's size: the store
   swept below it and the sweep logged.
18. the live plane.  First B1 on Queue C3's (1, 6,000) block (N(0, 1)·1e20,
   rows 2,000 onward null) against its plain version: the same n, min,
   max and nonzero, M2 +inf and M3 NaN in both, and the finalized variance,
   stddev, skewness and kurtosis inf, inf, NaN, NaN in both.  Then
   configs_basic on phase 16's 100,000 rows in the default mode, each run
   with ``ANOVOS_TPU_TELEMETRY`` on a free port, ``ANOVOS_TPU_TRACE_ROTATE``
   at 4 spans, ``ANOVOS_TPU_FLIGHTREC``, ``ANOVOS_TPU_TRACE=1`` and
   ``ANOVOS_TPU_DEVPROF=full``, and a thread scraping ``/metrics``,
   ``/healthz`` and ``/statusz`` every 50 ms over one keep-alive
   connection: (a) a scraped run: at least 5 answers from each endpoint;
   /metrics parses as Prometheus text, no counter goes down from scrape to
   scrape, and cuda:0's memory gauges are there; /statusz shows a node on
   the card in flight on the cuda backend, with no ``doctor`` (no earlier
   manifest); B1 2 and B2 1 launched between the first and the last
   scrape, each held against its plain version on its inputs; the trace
   segments (at least 3) hold, event for event, an uninterrupted export of
   every span recorded before the final flush; the tree equals phase 16
   (c)'s, and no dump is written; (b) a chaos ``hang`` on the basic report
   under a 6 s ``node_timeout``: the escalation dumps
   ``flightrec_anovos_basic_report.json`` with the node in flight, the
   abandonment ``..._2.json``, the manifest names both and the section is
   degraded; (c) a second run in (a)'s directory with 3 s of device
   sleeps queued in the basic report: scraped as (a), /statusz carries the
   doctor's comparison with (a), and ``python -m
   anovos_tpu_torch.obs.diffing`` on (a)'s manifest and this run ranks
   first the phase whose top mover is the basic report, with a
   schema-valid diagnosis.  Each step's wall is printed on a line of its
   own.
19. serving (``anovos_tpu_torch.serving``): (a) ``DEMO_CHAIN`` (all ten
   servable families) fitted on 1,000,000 ``demo_frame`` rows, the bundle
   exported to a CAS store and read back: B1 launched, every launch held
   against its plain version on the inputs the fit gave it and timed at
   the first; (b) a ``FeatureServer`` with 256-row micro-batches and a
   5 ms window booted with the warm-up of the buckets 8-256: each bucket's
   wall, launches and new allocator segments printed; (c) 8 client
   threads send 50 requests each, widths cycling 1, 3, 8, 17, 32: every
   response byte-equal to its rows in one batch apply of all the load's
   rows, every 10th also to the batch apply of its own rows alone, and
   between the warm-up and the load's end no hand-kernel launch and no new
   CUDA allocator segment; (d) the nine hostile payloads of
   ``tests/test_serving.py`` refused with their five codes, then a request
   served equal to its batch apply; (e) the serve-fault scenario
   (``serving.demo.run_serve_fault``) passing every gate; (f) the CLI's
   ``smoke --telemetry --clients 2 --requests 10`` in-process.  It prints
   QPS, p50/p99, the cold start, the bucket walls and the launches beside
   the card's name and power limit, and leaves no thread, listener,
   provider or flight recorder arming behind.
20. the backend failover (``resilience/failover.py``): (a) the health
   probe on the live card: 20 round trips, each within the runner's 5 s
   deadline, then healthy within a 1 s deadline while a worker stream runs
   a 2 s device sleep (still running when the probe answers); an ordinary
   error pays no probe, a CUDA-shaped one pays one and flips nothing; (b)
   the ``full`` chaos scenario (``resilience/scenarios.py``: an exception,
   a hang and a wedge in one run of the synthetic config): ok, 3
   injections, 1 failover, at least 3 retries and 1 escalation, the two
   expected flight dumps and none on the clean runs, and the parity rule:
   each file byte-equal to the clean card run's, or, when a node that ran
   after the flip wrote it, to a clean CPU run's; (c) configs_full on
   20,000 rows in the concurrent mode, a clean card run, a clean CPU run
   and a run with ``wedge@node:drift_detector/drift_statistics``: 1
   failover, 1 failover re-execution, the drift node's 2 attempts, its
   ``backend_failover`` dump with ``pre_flip`` on the card and wedged, B1
   and B2 launches over the nodes before the flip equal to the clean card
   run's and none by a node after it, the launches held to plain, the
   parity rule, nothing degraded.  The phase ends on the card with no
   flip; no earlier phase flips.
21. the data-plane and continuum chaos scenarios
   (``resilience/scenarios.py``, each through its gate with the JAX
   gate's bounds): (a) ``corrupt-ingest``, the synthetic config's 1,500
   rows in four parts, two of which fail on every read: exactly those two
   quarantined with 375 rows each (the manifest and the on-disk
   ``quarantine_manifest.json``), exactly their two ``ingest/`` sections
   degraded, no flight dump, the chaos wall within 2 x the clean wall +
   90 s, and the chaos tree byte-equal to a clean card run over parts 0
   and 3 alone; (b) ``slowread-stream``, ``describe_streaming`` over
   eight 2,048-row parts, six read 0.6 s slowly: equal stats frames, no
   quarantine, at least 12 injections, the chaos wall within the clean
   wall + 4.32 s and an overlap of at least 0.3; (c) ``feed-30d``, the
   30-day feed at 500 rows a day folded day by day and as one batch:
   byte-equal trees, day 20 quarantined on both legs, a drift alert on or
   after day 25 with flight context, day 30's fold within 2 x day 2's.
   Each prints its walls, injections, overlap or fold ratio and launches;
   B1 (and B2 where the path runs it) is held to its plain version and
   timed on the surviving-row block of (a), a 2,048-row chunk of (b) and a
   daily block of (c).

It then prints a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.
Without a CUDA device it fails and prints no result.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# phase 2 times the kernels at the 4M-row bench's shapes (bench.py:39);
# phase 3 runs the main path on ROWS rows, and phases 6-8, 10a/b and 13-14
# go on with the first SUB_ROWS of them, read back with read_dataset.  Both
# cut from 4M: the script took 1,012 s of its 1,200 s limit with every
# phase at 4M rows on one host, and more than 1,200 s on a slower one,
# whose host work runs up to 2x slower (PERF.md section 4)
KERNEL_ROWS = 4_000_000
ROWS = 2_000_000
SUB_ROWS = 1_000_000
BIN_SIZE = 10
DROP = ["ifa", "dt_1", "dt_2", "empty", "logfnl"]
GEO_ROWS = 500_000  # cut from 1,000,000 (PERF.md section 4)
GEO_RECORDS = 100_000  # geospatial_autodetection's max_analysis_records default
GEO_B3_SAMPLE = 16_384
GEO_EPS = "0.3,0.5,0.05"
GEO_MIN_SAMPLES = "500,1100,100"
# DBSCAN combos of the 35 whose labels are bracketed by float64 (seeded;
# cut from 10, then from 4, about 4 s of host checks a combo; PERF.md
# section 4)
GEO_BRACKETED = 2
# the kernels each path must launch
PATH_KERNELS = {"income": ("masked_moments", "binned_histograms"),
                "geo_default": ("masked_moments",),
                "geo_grid_16384": ("masked_moments", "neighbor_counts"),
                "quality": ("masked_moments", "binned_histograms"),
                "association": ("masked_moments",),
                "runner": ("masked_moments", "binned_histograms"),
                "transformers": ("masked_moments",),
                "configs_yaml": ("masked_moments", "binned_histograms"),
                "configs_time_series": ("masked_moments", "binned_histograms"),
                "configs_geospatial": ("masked_moments", "binned_histograms"),
                "configs_mlflow": ("masked_moments", "binned_histograms"),
                "configs_feast": ("masked_moments", "binned_histograms"),
                "geo_transformers": (),
                "streaming": ("masked_moments", "binned_histograms"),
                "continuum": ("masked_moments", "binned_histograms"),
                "recommender": (),
                "sequential_basic": ("masked_moments", "binned_histograms"),
                "sequential_full": ("masked_moments", "binned_histograms"),
                "chaos": ("masked_moments",),
                "run_record": ("masked_moments", "binned_histograms"),
                "serving_export": ("masked_moments",),
                "serving_warm": (),
                "serving_load": (),
                "failover_clean": ("masked_moments", "binned_histograms"),
                "failover_wedge": ("masked_moments",),
                "dataplane_corrupt_ingest": ("masked_moments", "binned_histograms"),
                "dataplane_slowread_stream": ("masked_moments",),
                "dataplane_feed_30d": ("masked_moments", "binned_histograms")}
# phase 15: the recommender's queries (an industry and a usecase of the
# corpus, then two misspelt ones the embeddings resolve), the attributes it
# maps and the descriptions it ranks them against; the chaos run's rows,
# hung node and node bound (every node runs under the bound: 10 s keeps
# configs_full's slowest node, ts inspection, which took more than 5 s on
# a busy host, well inside it)
REC_QUERY = ("banking financial service and insurance", "fraud detection")
REC_MISSPELT = ("bankng and finance", "churn of customers")
REC_ATTRS = {"cust_age": "age of the customer", "txn_amt": "transaction amount in dollars",
             "loan_default": "whether the borrower defaulted", "CreditScoreBand": ""}
REC_TARGETS = ["customer age in years", "number of logins", "amount of the transaction"]
CHAOS_ROWS = 50_000
CHAOS_NODE = "association_evaluator/IV_calculation"
CHAOS_TIMEOUT = 10
# phase 6: the rows concatenated again (duplicates), the invalid-entry
# table, the join's main and side tables
DUP_ROWS = 100_000
INVALID_ROWS = 1_000_000
JOIN_ROWS = 1_000_000
JOIN_SIDE_ROWS = 100_000
SAMPLE_SIZE = 100_000  # drift statistics' default
OUTLIER_SAMPLE = 1_000_000  # outlier_detection's default
# config/configs_full.yaml's quality_checker block, in its order (a copy:
# the GPU machine need not have a YAML reader; a CPU test holds it equal)
QUALITY_CONFIG = {
    "duplicate_detection": {"list_of_cols": "all", "drop_cols": ["ifa"], "treatment": True},
    "nullRows_detection": {"list_of_cols": "all", "drop_cols": [], "treatment": True,
                           "treatment_threshold": 0.75},
    "invalidEntries_detection": {"list_of_cols": "all", "drop_cols": ["ifa"], "treatment": True,
                                 "output_mode": "replace"},
    "IDness_detection": {"list_of_cols": "all", "drop_cols": ["ifa"], "treatment": True,
                         "treatment_threshold": 0.9},
    "biasedness_detection": {"list_of_cols": "all", "drop_cols": ["income"], "treatment": True,
                             "treatment_threshold": 0.98},
    "outlier_detection": {
        "list_of_cols": "all", "drop_cols": ["ifa", "income", "label"], "detection_side": "upper",
        "detection_configs": {"pctile_lower": 0.05, "pctile_upper": 0.90, "stdev_lower": 3.0,
                              "stdev_upper": 3.0, "IQR_lower": 1.5, "IQR_upper": 1.5,
                              "min_validation": 2},
        "treatment": True, "treatment_method": "value_replacement", "pre_existing_model": False,
        "model_path": "NA", "output_mode": "replace"},
    "nullColumns_detection": {
        "list_of_cols": "all", "drop_cols": ["ifa", "income"], "treatment": True,
        "treatment_method": "MMM",
        "treatment_configs": {"method_type": "median", "pre_existing_model": False,
                              "model_path": "NA", "output_mode": "replace"}},
}
# phase 7: config/configs_full.yaml's cat_to_num_transformer and
# association_evaluator blocks (a copy, as QUALITY_CONFIG; a CPU test holds
# them equal), the columns monotonic_binning searches, the sketch's rsd,
# variable_clustering's default sample and the compensated-moments table
CAT_TO_NUM_CONFIG = {"list_of_cols": "all", "drop_cols": "ifa", "method_type": "unsupervised",
                     "encoding": "label_encoding"}
_ENCODING = {"bin_method": "equal_frequency", "bin_size": 10, "monotonicity_check": 0}
ASSOC_CONFIG = {
    "correlation_matrix": {"list_of_cols": "all", "drop_cols": ["ifa"]},
    "IV_calculation": {"list_of_cols": "all", "drop_cols": "ifa", "label_col": "income",
                       "event_label": ">50K", "encoding_configs": _ENCODING},
    "IG_calculation": {"list_of_cols": "all", "drop_cols": "ifa", "label_col": "income",
                       "event_label": ">50K", "encoding_configs": _ENCODING},
    "variable_clustering": {"list_of_cols": "all", "drop_cols": "ifa|income"},
}
MONOTONIC_COLS = ("age", "hours-per-week")
HLL_RSD = 0.05
VARCLUS_SAMPLE = 100_000
COMP_ROWS = (1 << 24) + 12_345
# phase 8: config/configs_basic.yaml's and configs_full.yaml's
# timeseries_analyzer blocks (copies, as QUALITY_CONFIG; a CPU test holds
# them equal), the synthesized columns added to phase 3's Table, and the
# aggregates, window columns and formats the transformer steps use
TS_BASIC_CONFIG = {"auto_detection": True, "id_col": "ifa", "tz_offset": "local",
                   "inspection": False, "analysis_level": "daily", "max_days": 3600}
TS_FULL_CONFIG = dict(TS_BASIC_CONFIG, inspection=True)
TS_EXTRA = ("ifa", "dt_1", "dt_2")
TS_AGGS = ("count", "min", "max", "sum", "mean", "median", "stddev")
TS_FORMATS = ("%Y-%m", "%Y-%m-%d")
TS_WINDOW_COLS = ("age", "fnlwgt")
TS_WINDOW_AGGS = ("mean", "min", "max")
TS_PREDICATES = ("is_monthStart", "is_monthEnd", "is_yearStart", "is_yearEnd", "is_quarterStart",
                 "is_quarterEnd", "is_yearFirstHalf", "is_leapYear", "is_weekend")
TS_SNAPS = ("start_of_month", "end_of_month", "start_of_year", "end_of_year", "start_of_quarter",
            "end_of_quarter")
# phase 9: config/configs_basic.yaml (a copy, as QUALITY_CONFIG; a CPU test
# holds basic_config() equal to the file after the same path substitution),
# the rows synthesized for it and its join side's rows
BASIC_CONFIG = {
    "input_dataset": {
        "read_dataset": {"file_path": None, "file_type": "parquet"},
        "delete_column": ["logfnl"],
        "select_column": None,
        "rename_column": {"list_of_cols": ["marital-status", "education-num"],
                          "list_of_newcols": ["marital_status", "education_num"]},
        "recast_column": {"list_of_cols": ["age", "education_num"], "list_of_dtypes": ["float", "float"]},
    },
    "join_dataset": {
        "join_cols": "ifa",
        "join_type": "inner",
        "dataset1": {"read_dataset": {"file_path": None, "file_type": "avro"},
                     "rename_column": {"list_of_cols": "age|workclass",
                                       "list_of_newcols": "dupl_age|dupl_workclass"}},
    },
    "timeseries_analyzer": TS_BASIC_CONFIG,
    "anovos_basic_report": {
        "basic_report": True,
        "report_args": {"id_col": "ifa", "label_col": "income", "event_label": ">50K",
                        "skip_corr_matrix": True, "output_path": "report_stats"},
    },
    "write_main": {"file_path": "output", "file_type": "parquet", "file_configs": {"mode": "overwrite"}},
}
RUNNER_ROWS = 250_000  # cut from 1,000,000 (PERF.md section 4)
RUNNER_SIDE_ROWS = RUNNER_ROWS  # every row joins, so the report profiles them all
# the basic report's tabs
BASIC_TABS = ("Executive Summary", "Wiki", "Descriptive Statistics", "Quality Check",
              "Attribute Associations", "Drift &amp; Stability")
# phase 10: config/configs_full.yaml whole (a copy, as BASIC_CONFIG; a CPU
# test holds full_config() equal to the file after the same substitution:
# the read paths and the two dictionaries, NA here), and the sizes and
# bands of its four parts
_INCOME_ETL = {
    "delete_column": ["logfnl", "empty", "dt_2"],
    "rename_column": {"list_of_cols": ["marital-status", "education-num"],
                      "list_of_newcols": ["marital_status", "education_num"]},
    "recast_column": {"list_of_cols": ["age", "education_num"], "list_of_dtypes": ["float", "float"]},
}
_CSV_READ = {"file_type": "csv", "file_configs": {"header": True, "delimiter": ",", "inferSchema": True}}
FULL_TRANSFORMERS = {
    "numerical_mathops": {"feature_transformation": {"list_of_cols": "all", "drop_cols": [],
                                                     "method_type": "sqrt"}},
    "numerical_binning": {"attribute_binning": {"list_of_cols": "all", "drop_cols": [],
                                                "method_type": "equal_frequency", "bin_size": 10,
                                                "bin_dtype": "numerical"}},
    "categorical_outliers": {"outlier_categories": {"list_of_cols": "all", "drop_cols": ["ifa", "income"],
                                                    "coverage": 0.9, "max_category": 20}},
    "categorical_encoding": {"cat_to_num_supervised": {"list_of_cols": "all", "drop_cols": ["ifa"],
                                                       "label_col": "income", "event_label": ">50K"}},
    "numerical_rescaling": {"IQR_standardization": {"list_of_cols": "all"}},
    "numerical_latentFeatures": {"PCA_latentFeatures": {"list_of_cols": "all", "explained_variance_cutoff": 0.95,
                                                        "standardization": False, "imputation": True}},
}
FULL_CONFIG = {
    "input_dataset": {"read_dataset": {"file_path": None, "file_type": "parquet"},
                      "delete_column": _INCOME_ETL["delete_column"], "select_column": None,
                      "rename_column": _INCOME_ETL["rename_column"],
                      "recast_column": _INCOME_ETL["recast_column"]},
    "timeseries_analyzer": TS_FULL_CONFIG,
    "geospatial_controller": {"geospatial_analyzer": {
        "auto_detection_analyzer": True, "id_col": "ifa", "max_analysis_records": GEO_RECORDS,
        "top_geo_records": 100, "max_cluster": 20, "eps": GEO_EPS, "min_samples": GEO_MIN_SAMPLES}},
    "anovos_basic_report": {"basic_report": False},
    "stats_generator": {"metric": ["global_summary", "measures_of_counts", "measures_of_centralTendency",
                                   "measures_of_cardinality", "measures_of_percentiles",
                                   "measures_of_dispersion", "measures_of_shape"],
                        "metric_args": {"list_of_cols": "all", "drop_cols": ["ifa"]}},
    "quality_checker": QUALITY_CONFIG,
    "cat_to_num_transformer": CAT_TO_NUM_CONFIG,
    "association_evaluator": ASSOC_CONFIG,
    "drift_detector": {
        "drift_statistics": {
            "configs": {"list_of_cols": "all", "drop_cols": ["ifa", "income"], "method_type": "all",
                        "threshold": 0.1, "bin_method": "equal_range", "bin_size": BIN_SIZE,
                        "pre_existing_source": False, "source_path": "NA"},
            "source_dataset": {"read_dataset": {"file_path": None, "file_type": "parquet"}, **_INCOME_ETL}},
        "stability_index": {
            "configs": {"metric_weightages": {"mean": 0.5, "stddev": 0.3, "kurtosis": 0.2},
                        "existing_metric_path": "", "appended_metric_path": "si_metrics", "threshold": 2},
            **{f"dataset{i}": {"read_dataset": {"file_path": None, **_CSV_READ}} for i in range(1, 5)}}},
    "report_preprocessing": {"master_path": "report_stats", "charts_to_objects": {
        "list_of_cols": "all", "drop_cols": "ifa", "label_col": "income", "event_label": ">50K",
        "bin_method": "equal_frequency", "bin_size": BIN_SIZE, "drift_detector": True, "outlier_charts": False,
        "source_path": "NA"}},
    "report_generation": {"master_path": "report_stats", "id_col": "ifa", "label_col": "income",
                          "corr_threshold": 0.4, "iv_threshold": 0.02, "drift_threshold_model": 0.1,
                          "dataDict_path": "NA", "metricDict_path": "NA", "final_report_path": "report_stats"},
    "transformers": FULL_TRANSFORMERS,
    "write_intermediate": {"file_path": "intermediate_data", **_CSV_READ,
                           "file_configs": {"mode": "overwrite", **_CSV_READ["file_configs"]}},
    "write_main": {"file_path": "output", "file_type": "parquet", "file_configs": {"mode": "overwrite"}},
    "write_stats": {"file_path": "stats", "file_type": "parquet", "file_configs": {"mode": "overwrite"}},
}
# 10b: configs_segmentation_unsupervised's autoencoder sample and batch;
# the epochs cut from 100, then from 10 to make room for phase 14, then
# from 3, and the sample from 500,000, then from 125,000 to make room for
# phase 20, then from 62,500 for phase 21, to keep the script near half
# its limit (PERF.md section 4)
AE_SAMPLE = 31_250  # cut from the config's 500,000 (PERF.md section 4)
AE_BATCH = 256
AE_EPOCHS = 2
# 10c: the imputers' table, its nulled columns, the KNN query rows checked
# against float64, and the bound on MF's standardized observed-cell RMSE
# (a rank-10 fit of 11 columns, 9 of them independent, leaves about a
# third of a σ)
IMPUTE_ROWS = 250_000  # cut from 1,000,000 (PERF.md section 4)
IMPUTE_COLS = ["age", "fnlwgt", "hours-per-week"]
# auto_imputation's choice on the card held against the CPU port's on the
# table's first AUTO_REF_ROWS rows (cut from IMPUTE_ROWS: the CPU reference
# took 95-142 s of the 1,200 s limit at 1M rows, 23 s at 250,000, 9.8 s at
# 100,000, cut to make room for phase 21; PERF.md section 4)
AUTO_REF_ROWS = 50_000
KNN_QUERIES = 300
MF_RMSE_BOUND = 0.5
# 10d: the rows of configs_full's input (cut from 4M, then from 200,000 to
# make room for phase 20; PERF.md section 4)
FULL_ROWS = 150_000
# phase 11: the host codec at scale (11a: an avro file of CODEC_ROWS rows of
# the full income schema; the pure-Python reference timed beside the codec
# on its first CODEC_REF_ROWS) and the four shipped configs no earlier phase
# runs, each a copy (the card's machine may lack a YAML reader) that a CPU
# test holds equal to its file after the same substitution: 11b
# configs.yaml on SCENARIO_ROWS input rows (twice as many after its
# concatenate), 11c the time-series, geospatial and mlflow configs on
# CHECKIN_ROWS rows each.  The rows are a depth cut forced by the 1,200 s
# limit (PERF.md section 4).
CODEC_ROWS = 250_000
CODEC_REF_ROWS = 10_000
SCENARIO_ROWS = 100_000
CHECKIN_ROWS = 50_000
_CSV_INPUT = {"read_dataset": {"file_path": None, **_CSV_READ}}
_CHECKIN_STATS = {"metric": ["global_summary", "measures_of_counts", "measures_of_centralTendency"],
                  "metric_args": {"list_of_cols": "all", "drop_cols": ["userId"]}}
_CHECKIN_REPORT = {
    "report_preprocessing": {"master_path": "report_stats",
                             "charts_to_objects": {"list_of_cols": "all", "drop_cols": ["userId"]}},
    "report_generation": {"master_path": "report_stats", "id_col": "userId", "dataDict_path": "NA",
                          "final_report_path": "report_stats"},
}
TS_SCENARIO_CONFIG = {
    "input_dataset": _CSV_INPUT,
    "timeseries_analyzer": {"auto_detection": True, "id_col": "userId", "tz_offset": "local", "inspection": True,
                            "analysis_level": "daily", "max_days": 36000},
    "anovos_basic_report": {"basic_report": False},
    "stats_generator": _CHECKIN_STATS,
    "drift_detector": {"stability_index": {
        "configs": {"metric_weightages": {"mean": 0.5, "stddev": 0.3, "kurtosis": 0.2},
                    "appended_metric_path": "si_metrics", "threshold": 2},
        **{f"dataset{i}": {"read_dataset": {"file_path": None, **_CSV_READ}} for i in range(1, 4)}}},
    **_CHECKIN_REPORT,
    "write_main": FULL_CONFIG["write_main"],
}
GEO_SCENARIO_CONFIG = {
    "input_dataset": _CSV_INPUT,
    "geospatial_controller": {"geospatial_analyzer": {
        "auto_detection_analyzer": True, "id_col": "userId", "max_analysis_records": 5000, "top_geo_records": 100,
        "max_cluster": 10, "eps": "0.3,0.5,0.2", "min_samples": "100,300,200",
        "global_map_box_val": "carto-positron"}},
    "anovos_basic_report": {"basic_report": False},
    "stats_generator": _CHECKIN_STATS,
    **_CHECKIN_REPORT,
    "write_main": FULL_CONFIG["write_main"],
}
MLFLOW_CONFIG = {
    "input_dataset": {"read_dataset": {"file_path": None, "file_type": "parquet"}, "delete_column": ["logfnl"],
                      "select_column": None, "rename_column": _INCOME_ETL["rename_column"],
                      "recast_column": _INCOME_ETL["recast_column"]},
    "stats_generator": FULL_CONFIG["stats_generator"],
    "quality_checker": {
        "duplicate_detection": {"list_of_cols": "all", "drop_cols": ["ifa"], "treatment": True},
        "nullColumns_detection": {"list_of_cols": "all", "drop_cols": ["ifa"], "treatment": True,
                                  "treatment_method": "MMM",
                                  "treatment_configs": {"method_type": "median", "pre_existing_model": False,
                                                        "model_path": "NA", "output_mode": "replace"}}},
    "report_preprocessing": {"master_path": "report_stats", "charts_to_objects": dict(
        FULL_CONFIG["report_preprocessing"]["charts_to_objects"], drop_cols=["ifa"], drift_detector=False)},
    "report_generation": FULL_CONFIG["report_generation"],
    "mlflow": {"experiment": "Anovos", "tracking_uri": "http://127.0.0.1:8889", "track_output": True,
               "track_reports": True, "track_intermediates": False},
    "write_main": FULL_CONFIG["write_main"],
}
FEAST_CONFIG = {
    "input_dataset": MLFLOW_CONFIG["input_dataset"],
    "stats_generator": {"metric": ["global_summary", "measures_of_counts", "measures_of_centralTendency",
                                   "measures_of_cardinality"],
                        "metric_args": {"list_of_cols": "all", "drop_cols": ["ifa"]}},
    "report_preprocessing": {"master_path": "report_stats", "charts_to_objects": {
        "list_of_cols": "all", "drop_cols": ["ifa"], "label_col": "income", "event_label": ">50K",
        "bin_method": "equal_frequency", "bin_size": 10, "drift_detector": False, "outlier_charts": False,
        "source_path": "NA"}},
    "write_feast_features": {
        "file_path": "feast_repo/",
        "entity": {"name": "income", "description": "income data", "id_col": "ifa"},
        "file_source": {"description": "data source description", "owner": "me@business.com",
                        "timestamp_col": "event_time", "create_timestamp_col": "create_time_col"},
        "feature_view": {"name": "income_view", "owner": "view@owner.com", "ttl_in_seconds": 3600000,
                         "create_timestamps": True},
        "service_name": "income_feature_service"},
    "write_main": {"file_path": "output", "file_type": "parquet",
                   "file_configs": {"mode": "overwrite", "repartition": 1}},
}
# configs_feast also runs on the CPU at FEAST_CPU_ROWS rows, whose anovos.py
# the card's must equal
FEAST_CPU_ROWS = 2_000
# phase 12: the geospatial transformers on GEO_T_ROWS rows (the rows the
# phases after phase 3 go on with) with GEO_T_IDS distinct ids; the dms steps, which make a
# Python string a value, on the first GEO_T_DMS_ROWS (cut from 1,000,000
# to make room for phase 14; PERF.md section 4);
# geohash strings checked on GEO_T_SAMPLE rows; polygon flags checked
# against float64 except within GEO_T_EDGE degrees of an edge (the f32
# spacing at |lon| in [64, 128) is 7.6e-6 degrees)
GEO_T_ROWS = SUB_ROWS
GEO_T_IDS = 100_000
GEO_T_DMS_ROWS = 250_000
GEO_T_SAMPLE = 100_000
GEO_T_EDGE = 1e-5
# phase 13: the streaming folders (target parts, source parts, rows a part),
# the chunk, the commit a describe is killed after, the part the chaos run
# corrupts, and configs_full.yaml's drift_statistics options (a copy)
STREAM_PARTS = 16
STREAM_SRC_PARTS = 8
STREAM_PART_ROWS = 250_000  # cut from 1,000,000 (PERF.md section 4)
STREAM_CHUNK = 250_000
STREAM_KILL_AFTER = 5
STREAM_CHAOS_PART = 3
STREAM_DRIFT = {"list_of_cols": "all", "drop_cols": ["ifa", "income"], "method_type": "all", "threshold": 0.1,
                "bin_method": "equal_range", "bin_size": 10}
STREAM_QUANTILES = (0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99)
# phase 14: the continuum's drift section (the baseline days fit the
# model), the further shift of the arriving day in σ, and the CLI the kill
# and the resume run through, as a user runs it
CONTINUUM_DRIFT = {"baseline": "base-*", "method_type": "all", "bin_size": 10, "threshold": 0.1}
CONTINUUM_SHIFT = 1.0
CONTINUUM_CLI = (sys.executable, "-m", "anovos_tpu_torch.continuum")
# phase 16: the rows of (b) and (c), phase 9's scheduler wall on the H100
# before the run record was added (PERF.md §5, at RUNNER_WALL_BEFORE_ROWS
# input rows), the kernels' names in
# the profiler trace and the slack between a kernel's device interval and
# the node range it runs under (the two clocks are aligned by the profiler)
RECORD_ROWS = 100_000
RUNNER_WALL_BEFORE_S = 16.44
RUNNER_WALL_BEFORE_ROWS = 1_000_000
# phase 17: the option of the basic report the incremental run edits, the
# exit code of the killed process, a CLI process's time limit (s)
CACHE_EDIT = ("event_label", "<=50K")
KILL_CODE = 9
CLI_TIMEOUT = 300
# what the phase's CLI processes run before the entry point (a CPU
# rehearsal puts its runtime on the CPU here)
CACHE_CLI_PRELUDE = ""
# phase 18: the scrape period (s) and the scrapes each endpoint must answer
# in a run, the span count the trace rotates at and the segments a run must
# leave, the node that hangs in (b) and its node_timeout (s), and the device
# sleeps (QUEUE_CYCLES each, about 10 ms) that slow it in (c)
LIVE_SCRAPE_PERIOD_S = 0.05
LIVE_MIN_SCRAPES = 5
LIVE_ROTATE = "4"
LIVE_MIN_SEGMENTS = 3
LIVE_HANG_NODE = "anovos_basic_report"
LIVE_HANG_TIMEOUT = 6
LIVE_SLEEP_CHUNKS = 300
# phase 19: the serving fit's rows (the income-shaped demo frame), the
# server's micro-batch and window, the load's clients and requests a client
SERVE_FIT_ROWS = 1_000_000
SERVE_MAX_BATCH = 256
SERVE_WINDOW_MS = 5.0
SERVE_CLIENTS = 8
SERVE_REQUESTS = 50
SERVE_SRC_ROWS = 5_000
SERVE_SMOKE_ARGS = ("smoke", "--telemetry", "--clients", "2", "--requests", "10")
# (c) holds every response to one batch apply of all the load's rows and
# every SERVE_OWN_EVERY-th to the batch apply of its own rows alone (an
# apply costs ~50 ms of host work at any bucket: 400 of them took 20 s)
SERVE_OWN_EVERY = 10
SERVE_THREAD_PREFIX = "anovos-torch-serve"
# phase 20: the health probe's round trips timed, the runner's default
# deadline, (a)'s deadline and the worker stream's device sleep past it;
# (c)'s rows and wedge (the node named: drift_detector/* also matches the
# stability index, a raise-mode node that takes no re-execution)
FAILOVER_PROBES = 20
FAILOVER_DEFAULT_DEADLINE_S = 5.0
FAILOVER_DEADLINE_S = 1.0
FAILOVER_BUSY_S = 2.0
FAILOVER_ROWS = 20_000
FAILOVER_NODE = "drift_detector/drift_statistics"
FAILOVER_WEDGE = f"seed=7;wedge@node:{FAILOVER_NODE}"
PROFILE_KERNEL_NAMES = {"masked_moments": "moments_kernel", "binned_histograms": "hist_kernel"}
PROFILE_KERNEL_CAT = "kernel"
RANGE_SLACK_US = 500.0
# the walls of the steps the host codec now runs, before the codec (PERF.md
# section 5: three runs on an NVIDIA H100 80GB HBM3 at 700.00 W, at the
# rows named, which phases 8 and 9 have since cut), printed beside this
# run's
BEFORE_CODEC_WALLS = {
    "phase 3 read_dataset, 4M-row parquet": "53.080; 50.119; 59.193 s",
    "phase 6 join_read_main_parquet, 1M rows": "15.04; 14.83; 26.72 s",
    "phase 6 write_avro, joined 100,000 rows": "4.34; 4.83; 6.43 s",
    "phase 6 read_avro, joined 100,000 rows": "5.69; 6.15; 7.33 s",
    "phase 8 set-up, ifa/dt_1/dt_2 encoded": "22.78; 30.65; 20.90 s at 4,000,000 rows",
    "phase 9 input read and final write": "17.223; 17.309; 20.802 s at 1,000,000 rows",
    "phase 9 join_dataset": "6.240 s at 1,000,000 rows with a 100,000-row side (0.943; 1.097 s)",
}
# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# kernel timing: repeats of back-to-back launches; the cold-L2 flush buffer
TIME_REPS = 5
TIME_ITERS = 50
COLD_BYTES = 128 * 2**20
# a device sleep (clock cycles, about 10 ms) that the timed launches queue
# behind
QUEUE_CYCLES = 20_000_000
# f32 operations of kernel B1 a value read (csrc/moments.cu push_step, an
# FMA counted as two, as the peak rate counts it): 3 for the count and the
# first valid value, 3 for the step sum, 16 for the centred powers, min,
# max and nonzero, and about 2 for the step's division and Chan merge.  The
# mask selects rather than branches, so masked values cost the same.
B1_OPS_PER_VALUE = 24
# unaligned row counts the kernels are checked at (≡ 1, 2, 3 mod 4, none a
# multiple of 16), with their column counts: the stability slices of the
# 4M-row path, a ragged shape, one row past a B1 work item, a tiny one
UNALIGNED = ((1_333_333, 9), (1_333_334, 9), (1_234_567, 5), (16_387, 3), (4_098, 5),
             (2_049, 4), (7, 4), (1, 4))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


class executor:
    """``ANOVOS_TPU_EXECUTOR`` set to ``mode`` inside the block (``None``:
    unset, the runner's default), restored after it."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.saved = os.environ.pop("ANOVOS_TPU_EXECUTOR", None)
        if self.mode is not None:
            os.environ["ANOVOS_TPU_EXECUTOR"] = self.mode
        return self

    def __exit__(self, *exc):
        os.environ.pop("ANOVOS_TPU_EXECUTOR", None)
        if self.saved is not None:
            os.environ["ANOVOS_TPU_EXECUTOR"] = self.saved


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(torch, fn, cold: bool = False, iters: int = TIME_ITERS,
                 reps: int = TIME_REPS) -> dict:
    """Device time of ``fn`` a launch as ``reps`` repeats of ``iters``
    launches: their min, median and max (ms), and every repeat.  ``fn``
    must not wait for the device.

    Warm: the launches run back to back, timed together, so inputs that fit
    the 50 MB L2 stay there.  Cold: before each launch, outside its timed
    window, a 128 MB buffer is written, so the launch finds its inputs in
    device memory, as the drift caller does after building its inputs.
    Either way the launches are queued behind a device sleep, so the
    device never waits for the host's wrapper calls: the time is the
    device's."""
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(COLD_BYTES // 4, dtype=torch.float32, device="cuda") if cold else None
    per = []
    for _ in range(reps):
        evs = []
        torch.cuda._sleep(QUEUE_CYCLES)
        for _ in range(iters if cold else 1):
            if cold:
                flush.fill_(1.0)
                torch.cuda._sleep(QUEUE_CYCLES // 100)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(1 if cold else iters):
                fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        per.append(sum(a.elapsed_time(b) for a, b in evs) / iters)
    return {"min": min(per), "median": float(np.median(per)), "max": max(per), "repeats": per}


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time a call of ``fn`` (µs) on a shape whose device time is
    negligible: what a wrapper call costs the host, checks, allocation and
    launch included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def spread(t: dict) -> str:
    return f"{t['median']:.5f} ms (min {t['min']:.5f}, max {t['max']:.5f})"


def bound(nbytes: float, ops: float):
    """(least ms, what bounds it) on the card for this many bytes and f32 ops.

    The f32 rate is the data sheet's, which counts an FMA as two
    operations, so a kernel that issues i instructions for work the bound
    counts as o operations can come no closer to it than o / (2 i): for
    B3, (2d + 3) / (2 x its instructions a pair)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b3_loop_sass(lib_path: str):
    """Instructions of B3's folded pair loop at d = 2 (``count_kernel<2>``
    in csrc/neighbor_counts.cu), from ``cuobjdump -sass`` of the built
    library: of the loops (a backward branch and the code from its target
    to it), the one with the most FFMA, which issues one FFMA a pair.
    Returns its pairs, instructions, instructions a pair, opcode mix and
    text, or None where the toolkit has no cuobjdump."""
    from anovos_tpu_torch.ops.kernels import build

    exe = shutil.which("cuobjdump") or os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.isfile(exe):
        return None
    sass = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass)
                if "count_kernelILi2E" in f.split("\n", 1)[0])
    code, labels = [], {}  # (address, opcode, text); label -> address of what follows
    for line in body.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            labels[label.group(1)] = None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        if m:
            addr = int(m.group(1), 16)
            for name, at in labels.items():
                labels[name] = addr if at is None else at
            code.append((addr, m.group(2), line.split(";")[0].strip() + " ;"))
    best = None
    for addr, op, text in code:
        if op != "BRA":
            continue
        t = re.search(r"\((\.L_x_\d+)\)", text)
        target = labels.get(t.group(1)) if t else None
        if target is None:
            h = re.search(r"BRA\s+(?:`\()?0x([0-9a-f]+)", text)
            target = int(h.group(1), 16) if h else None
        if target is None or target > addr:
            continue
        loop = [c for c in code if target <= c[0] <= addr]
        if best is None or sum(c[1] == "FFMA" for c in loop) > sum(c[1] == "FFMA" for c in best):
            best = loop
    if best is None:
        return None
    ops = [c[1] for c in best]
    pairs = ops.count("FFMA")
    return {"pairs": pairs, "instructions": len(ops),
            "per_pair": len(ops) / pairs if pairs else None,
            "mix": {op: ops.count(op) for op in sorted(set(ops))}, "text": [c[2] for c in best]}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_inputs(torch, k: int, rows: int, gen, nbins: int = BIN_SIZE):
    dev = "cuda"
    X = torch.randn((k, rows), generator=gen, device=dev) * 20 + 50
    X[0] = torch.randn((rows,), generator=gen, device=dev) * 3 + 1e5
    X[1] = torch.randn((rows,), generator=gen, device=dev).abs() * 5
    M = torch.rand((k, rows), generator=gen, device=dev) > 0.1
    M[0, 0] = False  # the large-mean column starts with a null
    M[2] = False  # all-masked column
    X = torch.where(M, X, 0.0)  # a null is stored as 0, as in the Table
    cuts = torch.sort(torch.randn((k, nbins - 1), generator=gen, device=dev) * 20 + 50, dim=1).values
    cuts[0] = torch.linspace(1e5 - 6, 1e5 + 6, nbins - 1, device=dev)
    cuts[min(3, k - 1)] = float("nan")  # dead column: every value in bin 0
    return X.contiguous(), M.contiguous(), cuts.contiguous()


def moments_errors(acc: np.ndarray, ref: np.ndarray) -> dict:
    """Errors of the kernel's (8, k) accumulator against the plain one:
    n/min/max/nonzero must be equal; mean, M2, M3, M4 are checked against
    1e-5 relative plus 1e-5 · n · σ^p plus the shift a rounded 2048-row
    tile mean of the plain version gives them (Δ = 4 ulp of the tile sum
    over 2048; n·Δ², 3·Δ·M2 + n·Δ³, 4·Δ·|M3| + 6·Δ²·M2 + n·Δ⁴).  Returns
    the largest error as a share of its allowance per field."""
    a, e = acc.astype(np.float64), ref.astype(np.float64)
    for row, name in ((0, "n"), (5, "min"), (6, "max"), (7, "nonzero")):
        check(np.array_equal(acc[row], ref[row]), f"masked_moments {name} differs from plain")
    n = np.maximum(e[0], 1)
    sigma = np.sqrt(np.maximum(e[2], 0) / n)
    d = 4 * np.spacing(np.abs(e[1] * 2048).astype(np.float32)).astype(np.float64) / 2048
    allow = {
        "mean": 1e-5 * (np.abs(e[1]) + sigma),
        "M2": 1e-5 * np.abs(e[2]) + 1e-5 * n * sigma ** 2 + n * d ** 2,
        "M3": 1e-5 * np.abs(e[3]) + 1e-5 * n * sigma ** 3 + 3 * d * e[2] + n * d ** 3,
        "M4": 1e-5 * np.abs(e[4]) + 1e-5 * n * sigma ** 4 + 4 * d * np.abs(e[3])
        + 6 * d ** 2 * e[2] + n * d ** 4,
    }
    share = {}
    for row, name in ((1, "mean"), (2, "M2"), (3, "M3"), (4, "M4")):
        err = np.abs(a[row] - e[row])
        ok = err <= allow[name] + 1e-30
        check(bool(ok.all()), f"masked_moments {name} off: {err} > {allow[name]}")
        share[name] = float(np.max(err / (allow[name] + 1e-30)))
    return share


def b2_bound(k: int, rows: int, nbins: int, valid: int):
    """B2's least time: bytes, every value and mask byte read once, the
    cutoffs read and the counts written; operations, a compare and an add
    for each cutoff and value read (the mask selects, it does not branch)
    and one count for each valid value."""
    return bound(rows * k * 5 + k * (nbins - 1) * 4 + k * nbins * 4,
                 rows * k * 2 * (nbins - 1) + valid)


def b1_bound(k: int, rows: int):
    """B1's least time: bytes, every value and mask byte read once and 32
    bytes a column written; operations, B1_OPS_PER_VALUE a value read."""
    return bound(rows * k * 5 + 8 * k * 4, rows * k * B1_OPS_PER_VALUE)


def check_moments_twice(torch, X, M, what: str):
    """B1 on (X, M) twice: the two results are the same bits; returns one."""
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols

    a = masked_moments_cols(X, M)
    b = masked_moments_cols(X, M)
    torch.cuda.synchronize()
    # bit for bit: a NaN (an overflowed M3) equals itself here
    check(torch.equal(a.view(torch.int32), b.view(torch.int32)), f"masked_moments differs between two runs at {what}")
    return a


def b1_row(torch, Xc, Mc, path: str, what: str) -> dict:
    """B1 at a path's own (k, rows) shape and data: twice with the same
    bits, against its plain version within its allowance, timed warm and
    with a cold L2 beside the plain version and its byte bound."""
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain

    k, rows = Xc.shape
    acc = check_moments_twice(torch, Xc, Mc, what)
    share = moments_errors(acc.cpu().numpy(), masked_moments_plain(Xc, Mc).cpu().numpy())
    warm = kernel_times(torch, lambda: masked_moments_cols(Xc, Mc))
    cold = kernel_times(torch, lambda: masked_moments_cols(Xc, Mc), cold=True)
    plain_ms = cuda_ms(torch, lambda: masked_moments_plain(Xc, Mc), 2)
    b_ms, b_by = b1_bound(k, rows)
    print(f"kernel masked_moments at the {path} path ({k} x {rows}, {what}): warm {spread(warm)}, "
          f"cold L2 {spread(cold)}, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); error as "
          f"share of allowance {share}", flush=True)
    return {"path": path, "shape": [k, rows], "ms": warm["median"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "warm": warm, "cold": cold,
            "err_share_of_allowance": share}


def b2_row(torch, Xc, Mc, cuts, nbins: int, path: str, what: str) -> dict:
    """B2 at a path's own (k, rows) shape, data and cutoffs: equal to its
    plain version, timed warm and with a cold L2 beside the plain version
    and its bound."""
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain

    k, rows = Xc.shape
    got = binned_histograms_cols(Xc, Mc, cuts, nbins)
    plain = binned_histograms_plain(Xc, Mc, cuts, nbins)
    check(torch.equal(got, plain), f"binned_histograms differs from plain at the {path} path")
    warm = kernel_times(torch, lambda: binned_histograms_cols(Xc, Mc, cuts, nbins))
    cold = kernel_times(torch, lambda: binned_histograms_cols(Xc, Mc, cuts, nbins), cold=True)
    plain_ms = cuda_ms(torch, lambda: binned_histograms_plain(Xc, Mc, cuts, nbins), 3)
    b_ms, b_by = b2_bound(k, rows, nbins, int(Mc.sum().item()))
    print(f"kernel binned_histograms at the {path} path ({k} x {rows}, {nbins} bins, {what}): warm "
          f"{spread(warm)}, cold L2 {spread(cold)}, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}); exact", flush=True)
    return {"path": path, "shape": [k, rows, nbins], "ms": warm["median"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "warm": warm, "cold": cold,
            "max_abs_err": float((got - plain).abs().max().item())}


def phase_kernels(torch, seed: int, k_num: int) -> dict:
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain
    from anovos_tpu_torch.ops.reductions import finalize_moments

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}

    # unaligned row counts: every column after the first starts off the
    # 16-byte grid (all-masked column, NaN cutoffs, mean 1e5 in each)
    for rows, k in UNALIGNED:
        X, M, cuts = kernel_inputs(torch, k, rows, gen)
        h = binned_histograms_cols(X, M, cuts, BIN_SIZE)
        a = check_moments_twice(torch, X, M, f"({k}, {rows})")
        check(torch.equal(h, binned_histograms_plain(X, M, cuts, BIN_SIZE)),
              f"binned_histograms differs from plain at ({k}, {rows})")
        check(int(h.sum().item()) == int(M.sum().item()), "histogram total != valid count")
        moments_errors(a.cpu().numpy(), masked_moments_plain(X, M).cpu().numpy())
    print("kernels: unaligned shapes ok, rows " + ", ".join(str(r) for r, _ in UNALIGNED)
          + " (all-masked column, NaN cutoffs, mean 1e5; B1 bit-identical over two runs)", flush=True)

    # binned histogram at the drift path's shape: one side of the 4M-row
    # bench split, every numeric column
    rows_h = KERNEL_ROWS // 2
    X, M, cuts = kernel_inputs(torch, k_num, rows_h, gen)
    got = binned_histograms_cols(X, M, cuts, BIN_SIZE)
    plain = binned_histograms_plain(X, M, cuts, BIN_SIZE)
    check(torch.equal(got, plain), "binned_histograms differs from plain at the path shape")
    warm = kernel_times(torch, lambda: binned_histograms_cols(X, M, cuts, BIN_SIZE))
    cold = kernel_times(torch, lambda: binned_histograms_cols(X, M, cuts, BIN_SIZE), cold=True)
    plain_ms = cuda_ms(torch, lambda: binned_histograms_plain(X, M, cuts, BIN_SIZE), 3)
    b_ms, b_by = b2_bound(k_num, rows_h, BIN_SIZE, int(M.sum().item()))
    out["binned_histograms"] = {"max_abs_err": float((got - plain).abs().max().item()),
                                "ms": warm["median"], "plain_ms": plain_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "library_ms": None, "warm": warm, "cold": cold,
                                "shape": [k_num, rows_h, BIN_SIZE]}
    print(f"kernel binned_histograms ({k_num} x {rows_h}, {BIN_SIZE} bins): warm {spread(warm)}, "
          f"cold L2 {spread(cold)}, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
          f"library none; exact", flush=True)

    # masked moments at stats_generator's shape: every numeric column of the
    # 4M-row table
    X, M, _ = kernel_inputs(torch, k_num, KERNEL_ROWS, gen)
    acc = check_moments_twice(torch, X, M, "the path shape")
    ref = masked_moments_plain(X, M)
    share = moments_errors(acc.cpu().numpy(), ref.cpu().numpy())

    def fin(t):
        f = finalize_moments(t[0], t[0] * t[1], t[2], t[3], t[4], t[5], t[6], t[7])
        return torch.stack([f[s] for s in ("mean", "stddev", "skewness", "kurtosis")])

    diff = (fin(acc) - fin(ref)).abs()
    max_err = float(torch.nan_to_num(diff, nan=0.0).max().item())
    warm = kernel_times(torch, lambda: masked_moments_cols(X, M))
    cold = kernel_times(torch, lambda: masked_moments_cols(X, M), cold=True)
    plain_ms = cuda_ms(torch, lambda: masked_moments_plain(X, M), 2)
    b_ms, b_by = b1_bound(k_num, KERNEL_ROWS)
    out["masked_moments"] = {"max_abs_err": max_err, "ms": warm["median"], "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                             "warm": warm, "cold": cold, "shape": [k_num, KERNEL_ROWS],
                             "err_share_of_allowance": share}
    print(f"kernel masked_moments ({k_num} x {KERNEL_ROWS}): warm {spread(warm)}, cold L2 {spread(cold)}, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), library none; max |Δ| of "
          f"mean/stddev/skew/kurt {max_err:.3g}, error as share of allowance {share}", flush=True)

    # masked moments at a stability slice's shape (3 of the path's 4 launches)
    rows_s = KERNEL_ROWS // 3
    X, M, _ = kernel_inputs(torch, k_num, rows_s, gen)
    warm = kernel_times(torch, lambda: masked_moments_cols(X, M))
    cold = kernel_times(torch, lambda: masked_moments_cols(X, M), cold=True)
    b_ms, b_by = b1_bound(k_num, rows_s)
    out["masked_moments"]["other_shapes"] = [{"path": "stability", "shape": [k_num, rows_s],
                                              "ms": warm["median"], "bound_ms": b_ms,
                                              "bound_by": b_by, "warm": warm, "cold": cold}]
    print(f"kernel masked_moments at a stability slice ({k_num} x {rows_s}): warm {spread(warm)}, "
          f"cold L2 {spread(cold)}, bound {b_ms:.5f} ms ({b_by})", flush=True)

    X, M, cuts = kernel_inputs(torch, 4, 1000, gen)
    out["masked_moments"]["host_us"] = host_us(torch, lambda: masked_moments_cols(X, M))
    out["binned_histograms"]["host_us"] = host_us(
        torch, lambda: binned_histograms_cols(X, M, cuts, BIN_SIZE))
    print(f"kernels: host time a wrapper call at (4, 1000): masked_moments "
          f"{out['masked_moments']['host_us']:.2f} µs, binned_histograms "
          f"{out['binned_histograms']['host_us']:.2f} µs", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def reference_psi(src, tgt, bin_size: int) -> dict:
    """PSI per column in float64 numpy/pandas: equal-range cutoffs from the
    source's min/max, searchsorted side='left', counts over all rows,
    0 → 1e-4 smoothing (bench.py's pandas loop, the reference algorithm)."""
    import pandas as pd

    out = {}
    for col in src.columns:
        s, t = src[col], tgt[col]
        if pd.api.types.is_numeric_dtype(s):
            lo, hi = s.min(), s.max()
            cuts = [lo + j * (hi - lo) / bin_size for j in range(1, bin_size)]
            sb = np.searchsorted(cuts, s.to_numpy(), side="left")
            tb = np.searchsorted(cuts, t.to_numpy(), side="left")
            p = np.bincount(sb[~s.isna().to_numpy()], minlength=bin_size) / len(s)
            q = np.bincount(tb[~t.isna().to_numpy()], minlength=bin_size) / len(t)
        else:
            cats = sorted(set(s.dropna().astype(str)) | set(t.dropna().astype(str)))
            p = s.dropna().astype(str).value_counts().reindex(cats).fillna(0).to_numpy() / len(s)
            q = t.dropna().astype(str).value_counts().reindex(cats).fillna(0).to_numpy() / len(t)
        p = np.where(p <= 0, 1e-4, p)
        q = np.where(q <= 0, 1e-4, q)
        out[col] = float(((p - q) * np.log(p / q)).sum())
    return out


def check_stats(df, frames: dict, num_cols, cat_cols) -> None:
    """The eleven measures against float64 pandas on the same frame."""
    for name, f in frames.items():
        check(len(f) > 0, f"stats {name}: empty frame")
    counts = frames["measures_of_counts"].set_index("attribute")
    for c in df.columns:
        check(int(counts.loc[c, "fill_count"]) == int(df[c].notna().sum()), f"fill_count of {c}")
    uniq = frames["uniqueCount_computation"].set_index("attribute")
    for c in num_cols + cat_cols:
        exp = df[c].dropna().astype(str).nunique() if c in cat_cols else df[c].nunique()
        check(int(uniq.loc[c, "unique_values"]) == int(exp), f"unique_values of {c}")
    cen = frames["measures_of_centralTendency"].set_index("attribute")
    disp = frames["measures_of_dispersion"].set_index("attribute")
    pct = frames["measures_of_percentiles"].set_index("attribute")
    for c in num_cols:
        v = df[c].dropna().to_numpy(np.float64)
        m, sd = v.mean(), v.std(ddof=1)
        check(abs(cen.loc[c, "mean"] - m) <= 1e-4 + 1e-5 * abs(m), f"mean of {c}: {cen.loc[c, 'mean']} vs {m}")
        check(abs(disp.loc[c, "stddev"] - sd) <= 1e-4 + 1e-4 * sd, f"stddev of {c}")
        check(pct.loc[c, "min"] == np.round(v.min(), 4) and pct.loc[c, "max"] == np.round(v.max(), 4),
              f"min/max of {c}")
    modes = frames["mode_computation"].set_index("attribute")
    for c in cat_cols:
        vc = df[c].dropna().astype(str).value_counts()
        best = sorted(vc.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        check(modes.loc[c, "mode"] == best[0] and int(modes.loc[c, "mode_rows"]) == best[1],
              f"mode of {c}")
    shape = frames["measures_of_shape"]
    check(bool(np.isfinite(shape[["skewness", "kurtosis"]].to_numpy(np.float64)).all()),
          "skewness/kurtosis not finite")


def phase_path(torch, seed: int):
    """The main path; returns its figures, a Table of its first SUB_ROWS
    rows, the frame that Table was read from (phases 6-8, 10a/b and 13-14
    go on with both) and those rows' id and date columns (phase 8 adds
    them to the Table)."""
    import pandas as pd

    from examples._data import synthesize
    from anovos_tpu_torch.data_analyzer import stats_generator as sg
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
    from anovos_tpu_torch.drift_stability import stability_index_computation, statistics
    from anovos_tpu_torch.drift_stability.drift_detector import drift_device_args
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.drift_kernels import drift_side_full

    t0 = time.perf_counter()
    full = synthesize(ROWS, seed=seed)
    t_synth = time.perf_counter() - t0
    df, extra = full.drop(columns=DROP), full[list(TS_EXTRA)]
    del full
    out = {"rows": ROWS, "synth_s": t_synth}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "income")
        os.makedirs(data_dir)
        df.to_parquet(os.path.join(data_dir, "part-00000.parquet"), index=False)

        kernels.reset_launches()
        t0 = time.perf_counter()
        table = read_dataset(data_dir, "parquet")
        torch.cuda.synchronize()
        out["ingest_s"] = time.perf_counter() - t0
        check(table.nrows == ROWS and table.col_names == list(df.columns), "read_dataset shape")
        num_cols, cat_cols, _ = table.attribute_type_segregation()
        print(f"path: read {ROWS} rows x {table.ncols} columns ({len(num_cols)} numeric) "
              f"in {out['ingest_s']:.2f} s", flush=True)

        t0 = time.perf_counter()
        frames = {fn: getattr(sg, fn)(table) for fn in (
            "global_summary", "missingCount_computation", "nonzeroCount_computation",
            "measures_of_counts", "mode_computation", "measures_of_centralTendency",
            "uniqueCount_computation", "measures_of_cardinality", "measures_of_dispersion",
            "measures_of_percentiles", "measures_of_shape")}
        out["stats_s"] = time.perf_counter() - t0
        check_stats(df, frames, num_cols, cat_cols)
        print(f"path: stats_generator, 11 measures, {out['stats_s']:.2f} s; checked against pandas",
              flush=True)

        half = ROWS // 2
        src, tgt = table.slice_rows(0, half), table.slice_rows(half, ROWS)
        statistics(tgt, src, method_type="all", bin_size=BIN_SIZE, use_sampling=False,
                   source_path=os.path.join(tmp, "warm"))
        t0 = time.perf_counter()
        odf = statistics(tgt, src, method_type="all", bin_size=BIN_SIZE, use_sampling=False,
                         source_path=os.path.join(tmp, "run"))
        out["psi_wall_s"] = time.perf_counter() - t0
        out["psi_drift_rows_per_sec"] = ROWS / out["psi_wall_s"]
        ref = reference_psi(df.iloc[:half].reset_index(drop=True),
                            df.iloc[half:].reset_index(drop=True), BIN_SIZE)
        got = dict(zip(odf["attribute"], odf["PSI"]))
        check(set(got) == set(ref), f"drift columns {sorted(got)} != {sorted(ref)}")
        psi_err = max(abs(got[c] - ref[c]) for c in ref)
        check(psi_err <= 1e-4, f"PSI off the float64 reference by {psi_err}")
        out["psi_max_abs_err_vs_float64"] = psi_err
        for m in ("HD", "JSD", "KS"):
            check(bool(np.isfinite(odf[m].to_numpy(np.float64)).all()), f"{m} not finite")

        print(f"path: drift statistics (4 methods, {len(odf)} columns) {out['psi_wall_s']:.3f} s "
              f"wall, {out['psi_drift_rows_per_sec']:.1f} rows/s; PSI within {psi_err:.2e} "
              f"of float64", flush=True)

        thirds = [(i * ROWS // 3, (i + 1) * ROWS // 3) for i in range(3)]
        t0 = time.perf_counter()
        si = stability_index_computation(*[table.slice_rows(a, b) for a, b in thirds],
                                         appended_metric_path=os.path.join(tmp, "si"))
        out["stability_s"] = time.perf_counter() - t0
        check(list(si["attribute"]) == num_cols, "stability columns")
        hist = pd.read_csv(os.path.join(tmp, "si", "part-00000.csv"))
        for (i, (a, b)) in enumerate(thirds):
            for c in num_cols:
                v = df[c].iloc[a:b].dropna().to_numpy(np.float64)
                row = hist[(hist["idx"] == i + 1) & (hist["attribute"] == c)].iloc[0]
                check(abs(row["mean"] - v.mean()) <= 1e-5 * (abs(v.mean()) + v.std()),
                      f"stability mean of {c}, slice {i}")
                check(abs(row["stddev"] - v.std(ddof=1)) <= 1e-4 * v.std(ddof=1) + 1e-6,
                      f"stability stddev of {c}, slice {i}")
        print(f"path: stability_index_computation over 3 slices {out['stability_s']:.2f} s; "
              f"moments checked against pandas", flush=True)
        out["launches"] = dict(kernels.LAUNCHES)
        for name in PATH_KERNELS["income"]:
            check(out["launches"][name] > 0, f"kernel {name} was not launched on the main path")
        print(f"path: kernel launches {out['launches']}", flush=True)

        # after the path: the device part of a drift run alone, both sides'
        # histogram pass on resident data (not counted as path launches)
        args_t, args_s = drift_device_args(tgt, src, BIN_SIZE)
        out["psi_device_ms"] = cuda_ms(
            torch, lambda: (drift_side_full(*args_t), drift_side_full(*args_s)), 10)
        print(f"path: drift device pass (both sides) {out['psi_device_ms']:.3f} ms", flush=True)
        del table, src, tgt, args_t, args_s

        # the phases after this one go on with the first SUB_ROWS rows, read
        # back as this phase read its own (set-up, outside the path's walls)
        sub = min(SUB_ROWS, ROWS)
        df = df.iloc[:sub].reset_index(drop=True)
        extra = extra.iloc[:sub].reset_index(drop=True)
        sub_dir = os.path.join(tmp, "sub")
        os.makedirs(sub_dir)
        df.to_parquet(os.path.join(sub_dir, "part-00000.parquet"), index=False)
        t0 = time.perf_counter()
        table = read_dataset(sub_dir, "parquet")
        torch.cuda.synchronize()
        out["sub_ingest_s"] = time.perf_counter() - t0
        check(table.nrows == sub and table.col_names == list(df.columns), "read_dataset shape of the sub-table")
        print(f"path: the later phases go on with its first {sub} rows, read back in "
              f"{out['sub_ingest_s']:.2f} s", flush=True)
    return out, table, df, extra


# ---------------------------------------------------------------------------
# phase 4: the neighbour-count kernel against its plain version
# ---------------------------------------------------------------------------
def blob_points(n: int, seed: int, d: int = 2) -> np.ndarray:
    """Four 0.3-sd blobs in a ±40 box of width d (the JAX package's Pallas
    test at d = 2), centred in numpy f32 as ops/cluster.py centres them."""
    g = np.random.default_rng(seed)
    X = (g.uniform(-40, 40, (4, d))[g.integers(0, 4, n)] + g.normal(0, 0.3, (n, d))).astype(np.float32)
    return X - X.mean(axis=0, keepdims=True)


def neighbor_counts_bound(n: int, d: int):
    """Bytes: the points read once, the counts written once.  Operations:
    2d + 3 for each of the n² pairs, the least the function needs (d
    products and d − 1 sums of the dot, the doubling folded into the
    subtraction of |q|², the addition of |x|², the compare, the count).
    The kernel issues 6 instructions a pair at d = 2 (csrc/neighbor_counts.cu
    and phase 1's SASS count), a ceiling of 7/12 of this bound."""
    return bound(n * (d + 1) * 4, n * n * (2 * d + 3))


def time_neighbor_counts(torch, Xc, eps2: float, what: str) -> dict:
    """B3 on the card against its plain version on ``Xc``: equal counts,
    then both timed."""
    from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_plain, neighbor_counts_rows

    n, d = Xc.shape
    got = neighbor_counts_rows(Xc, eps2)
    plain = neighbor_counts_plain(Xc, eps2)
    check(torch.equal(got, plain), f"neighbor_counts differs from plain at {what}")
    warm = kernel_times(torch, lambda: neighbor_counts_rows(Xc, eps2))
    plain_ms = cuda_ms(torch, lambda: neighbor_counts_plain(Xc, eps2), 3)
    b_ms, b_by = neighbor_counts_bound(n, d)
    return {"max_abs_err": float((got - plain).abs().max().item()), "ms": warm["median"],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "warm": warm, "shape": [n, d]}


def b3_edge_cases(seed: int):
    """(what, points, eps²) at B3's edges: its launch shape (from the card's
    plan), its data and its inputs that take the literal form."""
    from anovos_tpu_torch.ops.kernels.neighbor_counts import launch_plan

    e16 = float(np.float32(0.4 * 0.4))
    for d in range(1, 9):
        yield f"d={d}", blob_points(3001, seed + d, d), float(np.float32(0.2 * d))
    tile = launch_plan(1, 2, "cuda")[3]
    split = launch_plan(GEO_B3_SAMPLE, 2, "cuda")[2]
    ragged = {}
    for n in range(GEO_B3_SAMPLE - 384, GEO_B3_SAMPLE + 416):
        _, splits, length, _ = launch_plan(n, 2, "cuda")
        if splits > 1:
            ragged.setdefault((n - (splits - 1) * length) % 8, n)
    check({0, 1, 7} <= set(ragged), f"no ragged last split found near {GEO_B3_SAMPLE}: {ragged}")
    sizes = sorted({1, 50, tile - 1, tile + 1, split - 1, split + 1, ragged[0], ragged[1], ragged[7]})
    for n in sizes:
        yield f"n={n}", blob_points(n, seed + n, 2), e16
    g = np.random.default_rng(seed)
    dup = blob_points(1500, seed, 2)[g.integers(0, 1500, 5000)]
    yield "eps2=0, duplicated points", dup, 0.0
    yield "duplicated points", dup, e16
    yield "eps beyond the diameter", dup, float(np.float32(1e4))
    i, j = np.meshgrid(np.arange(40), np.arange(30), indexing="ij")
    lat = (np.stack([i.ravel(), j.ravel()], 1) * 0.125 + g.uniform(-3, 3, (1, 2))).astype(np.float32)
    yield "spacing-eps lattice", lat - lat.mean(axis=0, keepdims=True), float(np.float32(0.125 ** 2))
    # 2·dot overflows where two points near (1.2e19, 1.2e19) meet
    for what, rows in (("a NaN point", {7: np.nan}), ("an infinite point", {11: np.inf}),
                       ("an overflowing dot", {0: 1.2e19, 1: 1.25e19, 2: -1.2e19})):
        X = blob_points(3000, seed, 2)
        for r, v in rows.items():
            X[r] = v
        yield what, X, e16
    yield "an infinite eps2", blob_points(3000, seed, 2), float("inf")


def phase_geo_kernels(torch, seed: int) -> dict:
    from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_plain, neighbor_counts_rows

    for n, eps in ((3000, 0.4), (1024, 0.05), (1500, 50.0), (257, 0.3)):
        Xc = torch.from_numpy(blob_points(n, seed + n)).cuda()
        eps2 = float(np.float32(eps * eps))
        got = neighbor_counts_rows(Xc, eps2)
        torch.cuda.synchronize()
        check(torch.equal(got, neighbor_counts_plain(Xc, eps2)),
              f"neighbor_counts differs from plain at n={n}, eps={eps}")
    print("kernels: neighbor_counts equal to plain at the Pallas test's shapes", flush=True)
    edges = []
    for what, X, eps2 in b3_edge_cases(seed):
        Xc = torch.from_numpy(np.ascontiguousarray(X)).cuda()
        got = neighbor_counts_rows(Xc, eps2)
        torch.cuda.synchronize()
        check(torch.equal(got, neighbor_counts_plain(Xc, eps2)), f"neighbor_counts differs from plain at {what}")
        if what == "eps2=0, duplicated points":
            _, inv, mult = np.unique(X, axis=0, return_inverse=True, return_counts=True)
            check(bool((got.cpu().numpy() >= mult[inv.ravel()]).all()), "eps2=0: a point misses a duplicate")
        if what == "eps beyond the diameter":
            check(bool((got == len(X)).all()), "eps beyond the diameter: a count is not n")
        edges.append(what)
    print(f"kernels: neighbor_counts equal to plain at {len(edges)} edge cases: {'; '.join(edges)}", flush=True)

    n, eps = 100_000, 0.4
    r = time_neighbor_counts(torch, torch.from_numpy(blob_points(n, seed)).cuda(),
                             float(np.float32(eps * eps)), f"n={n}")
    r["data"] = f"four blobs, eps {eps}"
    print(f"kernel neighbor_counts ({n} x 2, eps {eps}): {spread(r['warm'])}, plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library none; exact", flush=True)
    return r


# ---------------------------------------------------------------------------
# phase 5: the geospatial path
# ---------------------------------------------------------------------------
def six_city_points(g, n: int) -> np.ndarray:
    """(n, 2) lat/lon: six city centres at least 3 degrees apart in a
    continental box, points around them with σ = 0.3°, 2% uniform noise
    over the box."""
    centers = []
    while len(centers) < 6:
        c = (g.uniform(28, 46), g.uniform(-120, -75))
        if all(np.hypot(c[0] - a, c[1] - b) >= 3 for a, b in centers):
            centers.append(c)
    pts = np.asarray(centers)[g.integers(0, 6, n)] + g.normal(0, 0.3, (n, 2))
    noise = g.random(n) < 0.02
    pts[noise] = np.stack([g.uniform(25, 49, noise.sum()), g.uniform(-124, -71, noise.sum())], 1)
    return pts


def geo_frame(seed: int):
    """GEO_ROWS rows: six city centres at least 3 degrees apart in a
    continental box, points around them with σ = 0.3°, 2% uniform noise
    over the box, lat/lon with 1% nulls each, a precision-7 geohash of the
    same points (the port's encoder) and an id."""
    import pandas as pd

    from anovos_tpu_torch.data_transformer.geo_utils import geohash_encode

    g = np.random.default_rng(seed)
    pts = six_city_points(g, GEO_ROWS)
    lat, lon = pts[:, 0].copy(), pts[:, 1].copy()
    gh = np.array([geohash_encode(a, o, 7) for a, o in zip(lat.tolist(), lon.tolist())], object)
    lat[g.random(GEO_ROWS) < 0.01] = np.nan
    lon[g.random(GEO_ROWS) < 0.01] = np.nan
    return pd.DataFrame({"id": np.arange(GEO_ROWS), "latitude": lat, "longitude": lon, "geohash": gh})


def geo_files(lat: str, lon: str, gh, charts_only: bool = False):
    """The geo analyzer's files for a lat/lon pair and a geohash column
    (``gh`` None: no geohash column)."""
    pair, names = f"{lat}_{lon}", []
    fields = [pair] + ([gh] if gh else [])
    for field in fields:
        names += [f"geo_scatter_{field}", f"geo_heat_{field}"]
    if not charts_only:
        names += ["geospatial_stats.csv"]
        names += [f"geospatial_{kind}_{field}.csv" for field in fields for kind in ("overall", "top")]
        names += [f"{pre}_{kind}_{pair}.csv" for pre in ("geospatial", "cluster_output")
                  for kind in ("kmeans", "dbscan")]
    return names


def kmeans_float64_check(pts: np.ndarray, km) -> dict:
    """The k-means centers of ``km`` (the analyzer's frame) against a
    float64 Lloyd run over the same points from the same start, with the
    JAX package's stopping rule."""
    from anovos_tpu_torch.ops.cluster import kmeans_init_indices

    X = np.asarray(pts, np.float32).astype(np.float64)
    k = len(km)
    C = X[kmeans_init_indices(len(X), k, 0).numpy()]
    for _ in range(50):
        lbl = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1).argmin(1)
        cnt = np.bincount(lbl, minlength=k)
        sums = np.stack([np.bincount(lbl, weights=X[:, j], minlength=k) for j in range(2)], 1)
        Cn = np.where(cnt[:, None] > 0, sums / np.maximum(cnt, 1)[:, None], C)
        moved = bool((np.abs(Cn - C) > 1e-6 * (1 + np.abs(C))).any())
        C = Cn
        if not moved:
            break
    cnt = np.bincount(((X[:, None, :] - C[None, :, :]) ** 2).sum(-1).argmin(1), minlength=k)
    err = float(np.abs(km[["lat_center", "lon_center"]].to_numpy(np.float64) - C).max())
    check(err <= 1e-4, f"k-means centers off the float64 Lloyd run by {err}")
    return {"k": k, "center_max_abs_err": err,
            "count_diff": int(np.abs(km["count"].to_numpy() - cnt).sum())}


def dbscan_float64_check(sub: np.ndarray, eps_values, ms_eff, db, bracketed) -> dict:
    """On the grid sample ``sub`` of the B3 route, against float64 numpy and
    scipy.

    Counts: each eps's neighbour counts (kernel B3) may differ from the
    float64 counts only by band pairs, pairs whose float64 d² lies within
    tol = 8 f32 ulps of |q|² + |x|² (the scale of the f32 expansion's
    rounding) of eps².

    Labels: a float64 DBSCAN that counts only the pairs certainly within
    eps (d² ≤ eps² − tol) and one that counts every pair possibly within
    it (d² ≤ eps² + tol) bracket the port's graph, so for each combo in
    ``bracketed`` (a seeded sample of (eps index, min_samples index) pairs:
    the brackets' components are most of this check's time)
    (a) lo-core ⊆ port core ⊆ hi-core; (b) points of one lo component
    share one port label; (c) port core points of one label lie in one hi
    component; (d) a labelled non-core point has a core neighbour of its
    label within eps² + tol; (e) a non-core point with a lo-core point
    within eps² − tol is labelled.  The labels of every combo are
    recomputed with the port (the analyzer's calls) and must give the
    analyzer's frame ``db``."""
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from anovos_tpu_torch.ops.cluster import dbscan_grid, neighbor_counts
    from anovos_tpu_torch.shared.runtime import get_runtime

    Xc32 = np.asarray(sub, np.float32)
    Xc32 = Xc32 - Xc32.mean(axis=0, keepdims=True)
    X = Xc32.astype(np.float64)
    n, A = len(X), len(eps_values)
    eps2 = [float(np.float32(e * e)) for e in eps_values]
    # the pairs in float64 on the runtime's device (each step one correctly
    # rounded IEEE operation, as numpy's): the n² pairs took most of this
    # check's time on the host
    dev = get_runtime().device
    Xt = torch.from_numpy(X).to(dev)
    nrm = Xt[:, 0] * Xt[:, 0] + Xt[:, 1] * Xt[:, 1]
    counts64 = torch.zeros((A, n), dtype=torch.int64, device=dev)
    band = torch.zeros((A, n), dtype=torch.int64, device=dev)
    near_eps_ulps = torch.zeros(A, dtype=torch.int64, device=dev)
    ei, ej, ed, et = [], [], [], []
    for s in range(0, n, 2048):
        q = Xt[s:s + 2048]
        t = len(q)
        d0, d1 = q[:, None, 0] - Xt[None, :, 0], q[:, None, 1] - Xt[None, :, 1]
        d2 = d0 * d0 + d1 * d1
        del d0, d1
        s32 = (nrm[s:s + t, None] + nrm[None, :]).to(torch.float32)
        # np.spacing of a positive f32: the gap to the next f32 up
        tol = (8 * (torch.nextafter(s32, torch.full_like(s32, float("inf"))) - s32)).to(torch.float64)
        del s32
        diag = (torch.arange(t, device=dev), torch.arange(s, s + t, device=dev))
        for a, e2 in enumerate(eps2):
            ulps = 8 * float(np.spacing(np.float32(e2)))
            counts64[a, s:s + t] = (d2 <= e2).sum(1)
            gap = (d2 - e2).abs()
            inband = gap <= tol + ulps
            inband[diag] = False
            band[a, s:s + t] = inband.sum(1)
            near_eps_ulps[a] += (gap <= ulps).sum()
            del gap, inband
        edge = d2 <= max(eps2) + tol
        edge[diag] = False
        r, c = edge.nonzero(as_tuple=True)
        ei.append((r + s).to(torch.int32).cpu().numpy())
        ej.append(c.to(torch.int32).cpu().numpy())
        ed.append(d2[r, c].cpu().numpy())
        et.append(tol[r, c].cpu().numpy())
        del d2, tol, edge
    ei, ej, ed, et = (np.concatenate(v) for v in (ei, ej, ed, et))
    counts64, band, near_eps_ulps = (v.cpu().numpy() for v in (counts64, band, near_eps_ulps))

    out = {"n": n, "band_pairs": [int(b.sum()) // 2 for b in band],
           "pairs_within_8_ulps_of_eps2": [int(v) // 2 for v in near_eps_ulps],
           "count_mismatches": [], "lo_hi_cluster_counts": [], "combos": 0}
    rows = db.set_index(["eps", "min_samples"])
    ms_values = sorted({int(m) for m in db["min_samples"]})

    def components(edges, core):
        ri, ci = ei[edges & core[ei] & core[ej]], ej[edges & core[ei] & core[ej]]
        g = coo_matrix((np.ones(len(ri), np.int8), (ri, ci)), shape=(n, n))
        return connected_components(g, directed=True, connection="weak")[1]

    def is_function(a_, b_):
        """Every value of a_ comes with one value of b_."""
        pairs = np.unique(np.stack([a_, b_], 1), axis=0)
        return len(pairs) == len(np.unique(a_))

    for a, e in enumerate(eps_values):
        kc = neighbor_counts(sub, float(e))
        diff = np.abs(kc.astype(np.int64) - counts64[a])
        check(bool((diff <= band[a]).all()),
              f"neighbour counts at eps={e} differ from float64 beyond band pairs")
        out["count_mismatches"].append(int((diff > 0).sum()))
        labels = dbscan_grid(sub, float(e), ms_eff, counts=kc)
        lo, hi = ed <= eps2[a] - et, ed <= eps2[a] + et
        c_lo = np.bincount(ei[lo], minlength=n) + 1
        c_hi = np.bincount(ei[hi], minlength=n) + 1
        for b, ms in enumerate(ms_eff):
            lab = labels[b]
            row = rows.loc[(round(float(e), 4), ms_values[b])]
            check(int(row["n_clusters"]) == len(set(lab[lab >= 0]))
                  and float(row["noise_pct"]) == round(float((lab < 0).mean()), 4),
                  f"analyzer frame differs from a rerun at eps={e}, ms={ms}")
            if (a, b) not in bracketed:
                continue
            core_lo, core_p, core_hi = c_lo >= ms, kc >= ms, c_hi >= ms
            what = f"DBSCAN at eps={e}, ms={ms} against float64"
            check(bool((core_p >= core_lo).all() and (core_hi >= core_p).all()), f"{what}: (a) core sets")
            check(bool((lab[core_p] >= 0).all()), f"{what}: a core point is noise")
            comp_lo, comp_hi = components(lo, core_lo), components(hi, core_hi)
            check(is_function(comp_lo[core_lo], lab[core_lo]), f"{what}: (b) a lo component split")
            check(is_function(lab[core_p], comp_hi[core_p]), f"{what}: (c) a label spans hi components")
            m = hi & core_p[ej] & ~core_p[ei] & (lab[ei] == lab[ej])
            supported = np.zeros(n, bool)
            supported[ei[m]] = True
            border = ~core_p & (lab >= 0)
            check(bool(supported[border].all()), f"{what}: (d) a border label without a core neighbour")
            m = lo & core_lo[ej] & ~core_p[ei]
            check(bool((lab[ei[m]] >= 0).all()), f"{what}: (e) an unlabelled point next to a core")
            out["lo_hi_cluster_counts"].append(
                [len(np.unique(comp_lo[core_lo])), len(set(lab[lab >= 0])), len(np.unique(comp_hi[core_hi]))])
            out["combos"] += 1
    return out


def geo_path_kernels(torch, table, ll_cols, sub: np.ndarray, eps_values) -> dict:
    """The kernels at the shapes and on the data the geo path gives them,
    against their plain versions: B1 on the lat/lon block of the table (as
    ``ll_gh_cols`` calls it), B3 on the grid sample centred in numpy f32
    (as ``cluster.neighbor_counts`` centres it) at every eps of the grid."""
    X, M = table.numeric_block(ll_cols)
    b1 = b1_row(torch, X.t().contiguous(), M.t().contiguous(), "geo", "lat/lon")

    x32 = np.asarray(sub, np.float32)
    xc = torch.from_numpy(x32 - x32.mean(axis=0, keepdims=True)).cuda()
    b3 = []
    for e in eps_values:
        r = time_neighbor_counts(torch, xc, float(np.float32(e * e)), f"the geo grid sample, eps={e}")
        r["eps"] = e
        b3.append(r)
    print("kernel neighbor_counts at the geo path (" + " x ".join(map(str, b3[0]["shape"]))
          + "), equal to plain at every eps: ms " + ", ".join(f"{r['ms']:.4f}" for r in b3)
          + "; plain ms " + ", ".join(f"{r['plain_ms']:.4f}" for r in b3)
          + f"; bound {b3[0]['bound_ms']:.4f} ms ({b3[0]['bound_by']})", flush=True)
    warm = {"min": min(r["warm"]["min"] for r in b3),
            "median": float(np.median([r["warm"]["median"] for r in b3])),
            "max": max(r["warm"]["max"] for r in b3)}
    row = {"path": "geo_grid_16384", "shape": b3[0]["shape"], "warm": warm,
           "ms": float(np.mean([r["ms"] for r in b3])),
           "plain_ms": float(np.mean([r["plain_ms"] for r in b3])),
           "bound_ms": b3[0]["bound_ms"], "bound_by": b3[0]["bound_by"],
           "max_abs_err": max(r["max_abs_err"] for r in b3), "per_eps": b3}
    return {"masked_moments": b1, "neighbor_counts": row}


class ComponentCalls:
    """While in its ``with`` block, every call of the host codec's
    union-find by ``ops/cluster`` keeps its edges, threshold and labels
    (the edge arrays by reference: the caller never writes them)."""

    def __enter__(self):
        from anovos_tpu_torch.ops import cluster

        self.calls, self.saved = [], cluster.native_edge_components_minc
        saved, calls = self.saved, self.calls

        def call(ei, ej, minc, thresh, n):
            res = saved(ei, ej, minc, thresh, n)
            calls.append((ei, ej, minc, thresh, n, res[1]))
            return res

        cluster.native_edge_components_minc = call
        return self

    def __exit__(self, *exc):
        from anovos_tpu_torch.ops import cluster

        cluster.native_edge_components_minc = self.saved


def check_components(calls) -> int:
    """Each union-find call's labels equal scipy's weak components of the
    same graph (the edges with minc >= thresh over all n nodes): equal
    labels, not a permutation of them."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    for i, (ei, ej, minc, thresh, n, labels) in enumerate(calls):
        k = minc >= thresh
        g = coo_matrix((np.ones(int(k.sum()), np.int8), (ei[k], ej[k])), shape=(n, n))
        _, ref = connected_components(g, directed=True, connection="weak")
        check(np.array_equal(labels, ref), f"union-find call {i}: labels differ from scipy's components")
    return len(calls)


def phase_geo(torch, seed: int) -> dict:
    import pandas as pd

    from anovos_tpu_torch.data_analyzer import geospatial_analyzer as ga
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
    from anovos_tpu_torch.ops import kernels

    out = {"rows": GEO_ROWS}
    t0 = time.perf_counter()
    df = geo_frame(seed)
    out["synth_s"] = time.perf_counter() - t0
    lat, lon, gh = "latitude", "longitude", "geohash"
    e0, e1, estep = (float(x) for x in GEO_EPS.split(","))
    eps_values = [float(e) for e in np.arange(e0, e1 + 1e-9, estep)]
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "geo")
        os.makedirs(data_dir)
        df.to_parquet(os.path.join(data_dir, "part-00000.parquet"), index=False)
        t0 = time.perf_counter()
        table = read_dataset(data_dir, "parquet")
        torch.cuda.synchronize()
        out["ingest_s"] = time.perf_counter() - t0
        check(table.nrows == GEO_ROWS and table.col_names == list(df.columns), "geo read_dataset shape")
        print(f"geo: read {GEO_ROWS} rows x {table.ncols} columns in {out['ingest_s']:.2f} s", flush=True)

        out["launches"] = {}
        for path, sample in (("geo_default", None), ("geo_grid_16384", GEO_B3_SAMPLE)):
            master = os.path.join(tmp, path)
            if sample:
                os.environ["ANOVOS_DBSCAN_GRID_SAMPLE"] = str(sample)
            try:
                with ComponentCalls() as components:
                    kernels.reset_launches()
                    t0 = time.perf_counter()
                    found = ga.geospatial_autodetection(
                        table, "id", master, max_analysis_records=GEO_RECORDS, max_cluster=20,
                        eps=GEO_EPS, min_samples=GEO_MIN_SAMPLES)
                    torch.cuda.synchronize()
                    out[f"{path}_s"] = time.perf_counter() - t0
                    launches = out["launches"][path] = dict(kernels.LAUNCHES)
            finally:
                os.environ.pop("ANOVOS_DBSCAN_GRID_SAMPLE", None)
            # the default route's union-find (not the grid sample's device
            # labeling): each call's labels equal scipy's on the same edges
            check(bool(components.calls) != bool(sample), f"{path}: {len(components.calls)} union-find calls")
            out[f"{path}_union_find_checked"] = check_components(components.calls)
            del components
            check(found == ([lat], [lon], [gh]), f"{path}: detected {found}")
            for name in PATH_KERNELS[path]:
                check(launches[name] > 0, f"kernel {name} was not launched on the {path} path")
            want = len(eps_values) if sample else 0
            check(launches["neighbor_counts"] == want,
                  f"{path}: neighbor_counts launched {launches['neighbor_counts']} times, not {want}")
            missing = [f for f in geo_files(lat, lon, gh) if not os.path.isfile(os.path.join(master, f))]
            check(not missing, f"{path}: files not written: {missing}")
            db = pd.read_csv(os.path.join(master, f"geospatial_dbscan_{lat}_{lon}.csv"))
            check(len(db) == len(eps_values) * 7 and bool(np.isfinite(db["silhouette"]).all()),
                  f"{path}: DBSCAN grid frame")
            out[f"{path}_best_silhouette"] = float(db["silhouette"].max())
            out[f"{path}_clusters_at_best"] = int(db.loc[db["silhouette"].idxmax(), "n_clusters"])
            print(f"geo: geospatial_autodetection, {path} {out[f'{path}_s']:.2f} s, launches "
                  f"{launches}; best silhouette {out[f'{path}_best_silhouette']} with "
                  f"{out[f'{path}_clusters_at_best']} clusters", flush=True)

        charts = os.path.join(tmp, "charts")
        os.makedirs(charts)
        t0 = time.perf_counter()
        ga.generate_loc_charts_controller(table, "id", [lat], [lon], [gh], 100, master_path=charts)
        out["charts_s"] = time.perf_counter() - t0
        missing = [f for f in geo_files(lat, lon, gh, charts_only=True)
                   if not os.path.isfile(os.path.join(charts, f))]
        check(not missing, f"charts not written: {missing}")

        km = pd.read_csv(os.path.join(tmp, "geo_default", f"geospatial_kmeans_{lat}_{lon}.csv"))
        km2 = pd.read_csv(os.path.join(tmp, "geo_grid_16384", f"geospatial_kmeans_{lat}_{lon}.csv"))
        check(km.equals(km2), "k-means frames of the two routes differ")
        db = pd.read_csv(os.path.join(tmp, "geo_grid_16384", f"geospatial_dbscan_{lat}_{lon}.csv"))

    # after the timed runs (these launches are not counted): the kernels at
    # this path's shapes and data, then the float64 checks
    pts = ga._latlon_points(table, lat, lon, GEO_RECORDS)
    sub = pts[np.random.default_rng(2).choice(len(pts), GEO_B3_SAMPLE, replace=False)]
    out["kernels"] = geo_path_kernels(torch, table, [lat, lon], sub, eps_values)
    t0 = time.perf_counter()
    out["kmeans_check"] = kmeans_float64_check(pts, km)
    frac = len(sub) / len(pts)
    m0, m1, mstep = (int(float(x)) for x in GEO_MIN_SAMPLES.split(","))
    ms_eff = [max(2, int(round(m * frac))) for m in range(m0, m1 + 1, mstep)]
    combos = [(a, b) for a in range(len(eps_values)) for b in range(len(ms_eff))]
    pick = np.random.default_rng(seed + 5).choice(len(combos), GEO_BRACKETED, replace=False)
    out["dbscan_check"] = dbscan_float64_check(sub, eps_values, ms_eff, db,
                                               {combos[i] for i in pick})
    out["float64_checks_s"] = time.perf_counter() - t0
    print(f"geo: k-means vs float64 Lloyd {out['kmeans_check']}; B3 route vs float64 "
          f"{out['dbscan_check']}; charts {out['charts_s']:.2f} s", flush=True)
    check(torch.get_float32_matmul_precision() == "highest" and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmul precision changed")
    return out



# ---------------------------------------------------------------------------
# phase 6: sampling, the quality checks and the rest of ingest
# ---------------------------------------------------------------------------
AUTO_NULLS = {"", " ", "nan", "null", "na", "inf", "n/a", "not defined", "none", "undefined",
              "blank", "unknown"}
AUTO_SPECIALS = set("&$;:.,*#@_?%!^()-/'")


def auto_invalid(value: str) -> bool:
    """The reference of invalidEntries_detection's auto rules for one
    value: lowercased and stripped, a null synonym, a lone special
    character, a token of three or more repeats of one letter or digit, or
    three or more characters in a run of consecutive code points."""
    s = value.lower().strip()
    if s in AUTO_NULLS or s in AUTO_SPECIALS:
        return True
    if re.search(r"\b([a-zA-Z0-9])\1\1+\b", s):
        return True
    return len(s) >= 3 and all(ord(b) - ord(a) == 1 for a, b in zip(s, s[1:]))


def timed(torch, walls: dict, name: str, fn):
    """``fn()`` timed on the host clock, ending in a device sync."""
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    return result


def upper_bound_f64(v: np.ndarray, cfg: dict):
    """The upper fence of outlier_detection (detection_side "upper") in
    float64 over all of ``v``: the min_validation-th smallest of the
    percentile, mean + k·stddev and IQR candidates, percentiles taken
    as elements ("lower"); None where the lower and upper percentiles
    coincide (a skewed column)."""
    p_lo, p_hi, q1, q3 = np.quantile(v, [cfg["pctile_lower"], cfg["pctile_upper"], 0.25, 0.75],
                                     method="lower")
    if p_lo == p_hi:
        return None
    cands = sorted([p_hi, v.mean() + cfg["stdev_upper"] * v.std(ddof=1),
                    q3 + cfg["IQR_upper"] * (q3 - q1)])
    return cands[cfg["min_validation"] - 1]


def check_quality_chain(steps: dict, tmp: str) -> dict:
    """Each check of the chain against pandas/numpy on the frame it was
    given (``steps``: check → (input Table, output Table, stats))."""
    import pandas as pd

    from anovos_tpu_torch.data_transformer.model_io import load_model_df

    out = {}
    cat, dedup, st = steps["duplicate_detection"]
    dup = st.set_index("metric")["value"]
    check(int(dup["duplicate_rows"]) == DUP_ROWS and dedup.nrows == cat.nrows - DUP_ROWS,
          f"duplicates: {dict(dup)}, {dedup.nrows} rows left")

    inp, _, st = steps["nullRows_detection"]
    exp = inp.to_pandas().isna().sum(axis=1).value_counts().sort_index()
    check(st["null_cols_count"].tolist() == exp.index.tolist()
          and st["row_count"].tolist() == exp.tolist(), "nullRows counts differ from pandas")

    inp, _, st = steps["invalidEntries_detection"]
    pdf = inp.to_pandas()
    out["invalid_income"] = {}
    for _, r in st.iterrows():
        bad = [b for b in r["invalid_entries"].split("|") if b]
        check(all(auto_invalid(b) for b in bad), f"invalid entries of {r['attribute']}: {bad[:5]}")
        col = pdf[r["attribute"]]
        if inp.columns[r["attribute"]].kind == "cat":
            n = int(col.isin(bad).sum())
        else:
            n = int(np.isin(col.to_numpy(np.float32), np.array(bad, np.float64).astype(np.float32))
                    [col.notna().to_numpy()].sum())
        check(n == r["invalid_count"], f"invalid count of {r['attribute']}: {r['invalid_count']} vs {n}")
        if n:
            out["invalid_income"][r["attribute"]] = n

    inp, _, st = steps["IDness_detection"]
    pdf = inp.to_pandas()
    for _, r in st.iterrows():
        col = pdf[r["attribute"]]
        check(int(r["unique_values"]) == col.nunique()
              and abs(r["IDness"] - col.nunique() / col.notna().sum()) <= 5e-5 + 1e-12,
              f"IDness of {r['attribute']}")
    out["id_dropped"] = st.loc[st["treated"] == 1, "attribute"].tolist()

    inp, _, st = steps["biasedness_detection"]
    pdf = inp.to_pandas()
    for _, r in st.iterrows():
        vc = pdf[r["attribute"]].value_counts()
        check(int(r["mode_rows"]) == int(vc.max())
              and abs(r["mode_pct"] - vc.max() / vc.sum()) <= 5e-5 + 1e-12, f"mode of {r['attribute']}")
    out["biased_dropped"] = st.loc[st["treated"] == 1, "attribute"].tolist()

    inp, treated, st = steps["outlier_detection"]
    cfg = QUALITY_CONFIG["outlier_detection"]["detection_configs"]
    model = load_model_df(os.path.join(tmp, "outlier"), "outlier_numcols")
    pdf = inp.to_pandas()
    counts = st.set_index("attribute")["upper_outliers"]
    out["outlier_bounds"] = {}
    for _, r in model.iterrows():
        c, params = r["attribute"], [str(x) for x in r["parameters"]]
        v = pdf[c].dropna().to_numpy(np.float64)
        ref = upper_bound_f64(v, cfg)
        if "skewed_attribute" in params:
            check(ref is None, f"outlier: {c} skewed on the sample only")
            continue
        hi = float(params[1])
        check(ref is not None and abs(hi - ref) <= 0.01 * abs(ref),
              f"outlier bound of {c}: {hi} vs float64 {ref}")
        n = int((v.astype(np.float32) > np.float32(hi)).sum())
        check(int(counts[c]) == n, f"outlier count of {c}: {counts[c]} vs {n}")
        tc = treated.columns[c]
        check(float(tc.data[tc.mask].max()) <= np.float32(hi), f"{c} not clipped")
        out["outlier_bounds"][c] = {"port": hi, "float64_all_rows": float(ref), "count": n}

    inp, treated, _ = steps["nullColumns_detection"]
    out["imputed_medians"] = {}
    num_cols, _, _ = inp.attribute_type_segregation()
    for c in num_cols:
        col = inp.columns[c]
        null = ~col.mask
        if c in QUALITY_CONFIG["nullColumns_detection"]["drop_cols"] or not bool(null.any()):
            continue
        v = np.sort(col.data[col.mask].float().cpu().numpy())
        med = v[(len(v) - 1) // 2]
        filled = treated.columns[c].data[null].float().unique().cpu().numpy()
        check(filled.tolist() == [med] and bool(treated.columns[c].mask.all()),
              f"imputed median of {c}: {filled[:3]} vs {med}")
        out["imputed_medians"][c] = float(med)
    check(bool(out["imputed_medians"]), "nullColumns: no column was imputed")
    return out


def quality_path_kernels(torch, outlier_in, tgt, src) -> dict:
    """The kernels at the shapes and on the data the quality path gave
    them, against their plain versions, timed: B1 on outlier_detection's
    1,000,000-row sample (seed 11) of its columns, B2 on the sampled drift
    target binned against the sampled source's cutoffs (the same seeded
    draws as the path's)."""
    from anovos_tpu_torch.data_ingest.data_sampling import data_sample
    from anovos_tpu_torch.drift_stability.drift_detector import drift_device_args

    num_all, _, _ = outlier_in.attribute_type_segregation()
    cols = [c for c in num_all if c not in QUALITY_CONFIG["outlier_detection"]["drop_cols"]]
    sub = data_sample(outlier_in, fraction=OUTLIER_SAMPLE / outlier_in.nrows, seed_value=11)
    X, M = sub.numeric_block(cols)
    b1 = b1_row(torch, X.t().contiguous(), M.t().contiguous(), "quality", "outlier sample")

    p = SAMPLE_SIZE / tgt.nrows
    (datas, masks, cuts, *_), _ = drift_device_args(data_sample(tgt, fraction=p, seed_value=42),
                                                    data_sample(src, fraction=p, seed_value=42),
                                                    BIN_SIZE)
    Xc = torch.stack([d.to(torch.float32) for d in datas]).contiguous()
    Mc = torch.stack(list(masks)).contiguous()
    b2 = b2_row(torch, Xc, Mc, cuts.contiguous(), BIN_SIZE, "quality", "sampled drift target")
    return {"masked_moments": b1, "binned_histograms": b2}


def phase_quality(torch, seed: int, table, df) -> dict:
    """Phase 6 on phase 3's SUB_ROWS-row Table and its frame ``df``."""
    import pandas as pd

    from examples._data import synthesize
    from anovos_tpu_torch.data_analyzer import quality_checker as qc
    from anovos_tpu_torch.data_ingest.data_ingest import (concatenate_dataset, join_dataset, read_dataset,
                                                          recommend_type, rename_column, select_column,
                                                          write_dataset)
    from anovos_tpu_torch.data_ingest.data_sampling import data_sample
    from anovos_tpu_torch.drift_stability import statistics
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.shared.table import Table

    rows = table.nrows
    out = {"rows": rows + DUP_ROWS}
    walls = out["walls_s"] = {}
    g = np.random.default_rng(seed + 6)
    # set-up, not timed: the invalid-entry table and the join's main frame
    words = np.array(["alpha", "beta", "gamma", "delta", "omega"], object)
    tokens = np.array(["n/a", "unknown", "###", "aaa", "abc"], object)
    inv_col = words[g.integers(0, len(words), INVALID_ROWS)]
    hit = g.random(INVALID_ROWS) < 0.01
    inv_col[hit] = tokens[g.integers(0, len(tokens), int(hit.sum()))]
    inv_df = pd.DataFrame({"token": inv_col,
                           "code": g.choice([7, 123, 456, 1000], INVALID_ROWS).astype(np.int32)})
    inv_table = Table.from_pandas(inv_df)
    jdf = synthesize(JOIN_ROWS, seed=seed + 1)
    with tempfile.TemporaryDirectory() as tmp:
        jdir = os.path.join(tmp, "join_main")
        os.makedirs(jdir)
        jdf.to_parquet(os.path.join(jdir, "part-00000.parquet"), index=False)
        torch.cuda.synchronize()

        kernels.reset_launches()
        cat = timed(torch, walls, "concatenate",
                    lambda: concatenate_dataset(table, table.slice_rows(0, DUP_ROWS)))
        steps, t = {}, cat
        for name, kw in QUALITY_CONFIG.items():
            if name == "outlier_detection":  # persist the bounds to check them
                kw = dict(kw, model_path=os.path.join(tmp, "outlier"), sample_size=OUTLIER_SAMPLE)
            inp = t
            t, st = timed(torch, walls, name, lambda: getattr(qc, name)(inp, **kw))
            steps[name] = (inp, t, st)
        _, inv_stats = timed(torch, walls, "invalidEntries_1M_strings",
                             lambda: qc.invalidEntries_detection(inv_table))
        half = rows // 2
        src, tgt = table.slice_rows(0, half), table.slice_rows(half, rows)
        drift = timed(torch, walls, "sampled_drift_statistics",
                      lambda: statistics(tgt, src, method_type="all", bin_size=BIN_SIZE,
                                         sample_size=SAMPLE_SIZE,
                                         source_path=os.path.join(tmp, "drift")))
        rec = timed(torch, walls, "recommend_type", lambda: recommend_type(table))
        main = timed(torch, walls, "join_read_main_parquet", lambda: read_dataset(jdir, "parquet"))
        side_rows = np.arange(0, JOIN_ROWS, JOIN_ROWS // JOIN_SIDE_ROWS)
        side = rename_column(select_column(main, ["ifa", "age", "workclass"]).gather_rows(side_rows),
                             "age|workclass", "dupl_age|dupl_workclass")
        side_dir = os.path.join(tmp, "join_side")
        timed(torch, walls, "write_side_avro", lambda: write_dataset(side, side_dir, "avro"))
        side_back = timed(torch, walls, "read_side_avro", lambda: read_dataset(side_dir, "avro"))
        joined = timed(torch, walls, "join_dataset",
                       lambda: join_dataset(main, side_back, join_cols="ifa", join_type="inner"))
        backs = {}
        for ft in ("parquet", "csv", "avro"):
            d = os.path.join(tmp, f"joined_{ft}")
            timed(torch, walls, f"write_{ft}", lambda: write_dataset(joined, d, ft))
            backs[ft] = timed(torch, walls, f"read_{ft}", lambda: read_dataset(d, ft))
        out["launches"] = dict(kernels.LAUNCHES)
        for name in PATH_KERNELS["quality"]:
            check(out["launches"][name] > 0, f"kernel {name} was not launched on the quality path")
        out["seconds"] = sum(walls.values())
        print("quality: walls " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()), flush=True)
        print(f"quality: kernel launches {out['launches']}", flush=True)

        # after the timed steps (these launches are not counted): the kernels
        # at this path's shapes and data, then the checks
        out["kernels"] = quality_path_kernels(torch, steps["outlier_detection"][0], tgt, src)
        t0 = time.perf_counter()
        check(cat.nrows == rows + DUP_ROWS, f"concatenate: {cat.nrows} rows")
        out.update(check_quality_chain(steps, tmp))
        del steps

        vc = inv_df["token"].value_counts()
        exp = int(sum(n for v, n in vc.items() if auto_invalid(v)))
        codes = inv_df["code"].value_counts()
        exp_code = int(sum(n for v, n in codes.items() if auto_invalid(str(v))))
        got = inv_stats.set_index("attribute")["invalid_count"]
        check(int(got["token"]) == exp and int(got["code"]) == exp_code and exp > 0,
              f"invalid entries: {dict(got)} vs token {exp}, code {exp_code}")
        out["invalid_1M"] = {"token": exp, "code": exp_code}

        p = SAMPLE_SIZE / half
        sampled = [data_sample(t_, fraction=p, seed_value=42).nrows for t_ in (tgt, src)]
        check(all(abs(n - SAMPLE_SIZE) <= 5 * np.sqrt(half * p * (1 - p)) for n in sampled),
              f"sampled sides {sampled}")
        vals = drift[["PSI", "HD", "JSD", "KS"]].to_numpy(np.float64)
        check(bool(np.isfinite(vals).all()) and float(drift["PSI"].max()) < 0.1
              and int(drift["flagged"].sum()) == 0, "sampled drift: not finite or flagged")
        out["sampled_rows"] = sampled
        out["sampled_psi_max"] = float(drift["PSI"].max())

        for _, r in rec.iterrows():
            c = r["attribute"]
            col = df[c].to_numpy(np.float32) if df[c].dtype.kind == "f" else df[c]
            check(int(r["distinct_value_count"]) == pd.Series(col).nunique(), f"recommend_type of {c}")

        check(side_back.to_pandas().equals(side.to_pandas()), "join side changed through avro")
        ref = jdf.copy()
        for c in ref.columns:
            if ref[c].dtype.kind == "f":
                ref[c] = ref[c].astype(np.float32).astype(np.float64)
        right = ref.iloc[side_rows][["ifa", "age", "workclass"]].rename(
            columns={"age": "dupl_age", "workclass": "dupl_workclass"})
        ref = ref.merge(right, on="ifa", how="inner").sort_values("ifa").reset_index(drop=True)
        got_join = joined.to_pandas()
        try:
            pd.testing.assert_frame_equal(got_join.sort_values("ifa").reset_index(drop=True), ref,
                                          check_dtype=False)
            for ft, back in backs.items():
                pd.testing.assert_frame_equal(back.to_pandas(), got_join, check_dtype=False, obj=ft)
        except AssertionError as e:
            fail(f"join/write: {e}")
        out["joined_rows"] = joined.nrows
        out["checks_s"] = time.perf_counter() - t0
    print(f"quality: {len(QUALITY_CONFIG)} checks chained on {rows + DUP_ROWS} rows, invalid entries "
          f"{out['invalid_1M']} on {INVALID_ROWS} rows, sampled drift sides {out['sampled_rows']} "
          f"(PSI max {out['sampled_psi_max']:.4f}), join {out['joined_rows']} rows, written and "
          f"read back as parquet, csv and avro: checked ({out['checks_s']:.1f} s of checks)",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 7: association and the stats edges
# ---------------------------------------------------------------------------
def timed_launches(torch, walls: dict, launches: dict, name: str, fn):
    """``timed`` that also keeps the step's own kernel launches."""
    from anovos_tpu_torch.ops import kernels

    before = dict(kernels.LAUNCHES)
    result = timed(torch, walls, name, fn)
    launches[name] = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    return result


def iv_ig_reference(df, label: str, event: str, bins: int) -> dict:
    """IV and IG of every column but the label in float64 numpy: numeric
    columns binned at numpy's 'lower' quantiles j/bins of their f32 values
    (a value's bin: searchsorted side='left' on the f32 edges), then groups
    of the distinct bins or categories and one null group; 4 decimals."""
    import pandas as pd

    lab = df[label].notna().to_numpy()
    y = (df[label] == event).to_numpy(np.float64)
    total_event = y[lab].sum() / len(df)
    total_entropy = -(total_event * np.log2(total_event) + (1 - total_event) * np.log2(1 - total_event))
    out = {}
    for c in df.columns:
        if c == label:
            continue
        s = df[c]
        if s.dtype.kind == "f" or s.dtype.kind in "iu":
            x = s.to_numpy(np.float32)
            valid = ~np.isnan(x)
            edges = np.quantile(x[valid], [j / bins for j in range(1, bins)], method="lower")
            group = np.where(valid, np.searchsorted(edges.astype(np.float32), x, side="left"), -1)
        else:
            valid = s.notna().to_numpy()
            group = np.full(len(s), -1)
            group[valid] = pd.factorize(s[valid].astype(str), sort=True)[0]
        g = np.where(group >= 0, group, group.max() + 1)[lab]
        tot = np.bincount(g).astype(np.float64)
        l1 = np.bincount(g, weights=y[lab])
        keep = tot > 0
        l1, l0 = l1[keep], tot[keep] - l1[keep]
        nev, ev = l0 / l0.sum(), l1 / l1.sum()
        woe = np.where((nev != 0) & (ev != 0), np.log(np.maximum(nev, 1e-300) / np.maximum(ev, 1e-300)),
                       np.log(((l0 + 0.5) / l0.sum()) / ((l1 + 0.5) / l1.sum())))
        seg, rate = (l0 + l1) / (l0 + l1).sum(), l1 / (l0 + l1)
        with np.errstate(divide="ignore", invalid="ignore"):
            ent = -seg * (rate * np.log2(rate) + (1 - rate) * np.log2(1 - rate))
        ent = np.where((rate > 0) & (rate < 1), ent, np.nan)
        out[c] = (round(float(np.sum((nev - ev) * woe)), 4), round(float(total_entropy - np.nansum(ent)), 4))
    return out


def frequency_codes(s) -> dict:
    """Label codes by frequency, most frequent first, count ties to the
    category that sorts first."""
    vc = s.dropna().astype(str).value_counts()
    return {v: i for i, (v, _) in enumerate(sorted(vc.items(), key=lambda kv: (-kv[1], kv[0])))}


def varclus_reference(sample, cols) -> "pd.DataFrame":
    """VarClus over the float64 correlation of the sample as
    ``variable_clustering`` prepares it: columns with fewer than two
    distinct values dropped, categories label-encoded by frequency, nulls
    filled with the column mean."""
    import pandas as pd

    from anovos_tpu_torch.data_analyzer.association_eval_varclus import VarClus

    pdf = sample.to_pandas()
    cols = [c for c in cols if pdf[c].nunique() >= 2]
    enc = {}
    for c in cols:
        s = pdf[c]
        if pd.api.types.is_numeric_dtype(s):
            s = s.astype(np.float32).astype(np.float64)
        else:
            s = s.map(frequency_codes(s)).astype(np.float64)
        enc[c] = s.fillna(np.float64(np.float32(s.mean())))
    C = pd.DataFrame(enc).corr().to_numpy()
    rs = VarClus(pd.DataFrame(C, columns=cols, index=cols), maxeigval2=1.0).fit().rsquare_table()
    return pd.DataFrame({"Cluster": rs["Cluster"], "Attribute": rs["Variable"], "RS_Ratio": rs["RS_Ratio"]})


def comp_frame(seed: int):
    """COMP_ROWS rows x 9 f32 columns, 1% nulls each: three normals (one at
    1e5 with spread 3), a uniform and five skewed ones."""
    g = np.random.default_rng(seed + 7)
    n = COMP_ROWS
    gens = {"n_1e5": lambda: g.normal(1e5, 3, n), "n_1e3": lambda: g.normal(1e3, 1, n),
            "n_m50": lambda: g.normal(-50, 10, n), "unif": lambda: g.uniform(0, 1, n),
            "expo": lambda: g.exponential(5, n), "lognorm": lambda: g.lognormal(0, 1, n),
            "gamma": lambda: g.gamma(2, 3, n), "expo_1e4": lambda: 1e4 + g.exponential(2, n),
            "poisson": lambda: g.poisson(4, n)}
    data = {}
    for name, gen in gens.items():
        v = gen().astype(np.float32)
        v[g.random(n) < 0.01] = np.nan
        data[name] = v
    return data


def f64_moments(v: np.ndarray) -> dict:
    """Float64 mean, sample variance, skewness and excess kurtosis of ``v``
    (products, not ``**``: numpy's power is ~6x slower at 24M values)."""
    v = v.astype(np.float64)
    m = v.mean()
    d = v - m
    d2 = d * d
    m2 = d2.mean()
    return {"mean": m, "variance": d2.sum() / (len(v) - 1), "skewness": (d2 * d).mean() / m2 ** 1.5,
            "kurtosis": (d2 * d2).mean() / m2 ** 2 - 3.0}


def check_compensated(comp: dict, plain: dict, data: dict, cols) -> dict:
    """Compensated moments against float64 numpy on the same f32 values,
    with ten times PERF.md's compensated bands in the form
    tests/test_compensated_moments.py gives them (the larger of a relative
    and an absolute bound): mean ≤ 1e-7 relative, variance ≤ 1e-6 relative,
    skewness and kurtosis ≤ max(5e-7 relative, 2.5e-5 absolute).  Returns
    each error, absolute and relative, with the plain f32 whole-column one
    beside it."""
    out = {}
    for j, c in enumerate(cols):
        v = data[c]
        ref = f64_moments(v[~np.isnan(v)])
        out[c] = {}
        for k, rel, floor in (("mean", 1e-7, 0.0), ("variance", 1e-6, 0.0),
                              ("skewness", 5e-7, 2.5e-5), ("kurtosis", 5e-7, 2.5e-5)):
            err = abs(float(comp[k][j]) - ref[k])
            check(err <= max(rel * abs(ref[k]), floor),
                  f"compensated {k} of {c}: {comp[k][j]} vs float64 {ref[k]}")
            err_f32 = abs(float(plain[k][j]) - ref[k])
            out[c][k] = {"abs": err, "rel": err / abs(ref[k]), "plain_f32_abs": err_f32,
                         "plain_f32_rel": err_f32 / abs(ref[k])}
    return out


def phase_assoc(torch, seed: int, table, df) -> dict:
    """Phase 7 on the SUB_ROWS-row Table of phase 3 and its frame ``df``, then on
    a numeric Table of 2^24 + 12,345 rows."""
    import pandas as pd

    from anovos_tpu_torch.data_analyzer import association_evaluator as ae
    from anovos_tpu_torch.data_analyzer import stats_generator as sg
    from anovos_tpu_torch.data_analyzer.stats_generator import _exact_bits
    from anovos_tpu_torch.data_ingest.data_sampling import data_sample
    from anovos_tpu_torch.data_transformer import transformers as tr
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.describe import (chunk_view, compensated_moments, describe_numeric,
                                               table_describe)
    from anovos_tpu_torch.ops.hll import hll_registers, precision_for_rsd
    from anovos_tpu_torch.ops.reductions import masked_moments
    from anovos_tpu_torch.ops.segment import cat_valid_mask
    from anovos_tpu_torch.shared.table import Table

    walls, launches = {}, {}
    out = {"rows": table.nrows, "walls_s": walls, "launches_by_step": launches}
    num_cols, cat_cols, _ = table.attribute_type_segregation()
    flags = torch.backends.cuda.matmul
    os.environ["ANOVOS_COMPENSATED_MOMENTS"] = "auto"  # the default: 2^24 rows and more

    kernels.reset_launches()
    tf32_before = flags.allow_tf32
    flags.allow_tf32 = True  # the caller's global TF32: correlation_matrix must not use it
    try:
        corr = timed_launches(torch, walls, launches, "correlation_matrix",
                              lambda: ae.correlation_matrix(table, **ASSOC_CONFIG["correlation_matrix"]))
        check(flags.allow_tf32, "correlation_matrix changed the caller's TF32 setting")
    finally:
        flags.allow_tf32 = tf32_before
    iv = timed_launches(torch, walls, launches, "IV_calculation",
                        lambda: ae.IV_calculation(table, **ASSOC_CONFIG["IV_calculation"]))
    ig = timed_launches(torch, walls, launches, "IG_calculation",
                        lambda: ae.IG_calculation(table, **ASSOC_CONFIG["IG_calculation"]))
    vc = timed_launches(torch, walls, launches, "variable_clustering",
                        lambda: ae.variable_clustering(table, **ASSOC_CONFIG["variable_clustering"]))
    binned = timed_launches(torch, walls, launches, "attribute_binning_equal_range",
                            lambda: tr.attribute_binning(table, num_cols, method_type="equal_range",
                                                         bin_size=BIN_SIZE))
    mono = timed_launches(torch, walls, launches, "monotonic_binning",
                          lambda: tr.monotonic_binning(table, MONOTONIC_COLS, label_col="income",
                                                       event_label=">50K"))
    encoded = timed_launches(torch, walls, launches, "cat_to_num_transformer",
                             lambda: tr.cat_to_num_transformer(table, **CAT_TO_NUM_CONFIG))
    exact_u = timed_launches(torch, walls, launches, "uniqueCount_exact",
                             lambda: sg.uniqueCount_computation(table))
    approx_u = timed_launches(torch, walls, launches, "uniqueCount_approx",
                              lambda: sg.uniqueCount_computation(table, compute_approx_unique_count=True,
                                                                 rsd=HLL_RSD))
    # the stats edge: 2^24 + 12,345 rows (set-up not timed)
    comp_data = comp_frame(seed)
    big = Table.from_numpy(comp_data)
    torch.cuda.synchronize()
    big_cols = list(comp_data)
    big_frames = {}
    for fn in ("measures_of_centralTendency", "measures_of_dispersion", "measures_of_shape"):
        big_frames[fn] = timed_launches(torch, walls, launches, f"{fn}_{COMP_ROWS}",
                                        lambda: getattr(sg, fn)(big))
    out["launches"] = dict(kernels.LAUNCHES)
    for name in PATH_KERNELS["association"]:
        check(out["launches"][name] > 0, f"kernel {name} was not launched on the association path")
    vc_b1 = launches["variable_clustering"]["masked_moments"]
    mono_b1 = launches["monotonic_binning"]["masked_moments"]
    comp_b1 = sum(launches[f"{fn}_{COMP_ROWS}"]["masked_moments"] for fn in big_frames)
    check(vc_b1 >= 1 and 1 <= mono_b1 <= 19 * len(MONOTONIC_COLS) and comp_b1 >= 1,
          f"B1 launches: variable_clustering {vc_b1}, monotonic_binning {mono_b1}, compensated {comp_b1}")
    out["seconds"] = sum(walls.values())
    print("association: walls " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()), flush=True)
    print("association: kernel launches per step " + json.dumps(
        {k: v for k, v in launches.items() if any(v.values())}), flush=True)

    # after the timed steps (not counted): B1 at this path's two new shapes
    X, M = table.numeric_block([MONOTONIC_COLS[0]])
    b1_mono = b1_row(torch, X.t().contiguous(), M.t().contiguous(), "association",
                     f"monotonic_binning's {MONOTONIC_COLS[0]} column")
    Xb, Mb = big.numeric_block(big_cols)
    Xv, Mv, _ = chunk_view(Xb, Mb)
    b1_comp = b1_row(torch, Xv, Mv, "association", "the compensated moments' column-major chunk view")
    b1_comp["view_copy_ms"] = cuda_ms(torch, lambda: chunk_view(Xb, Mb), 5)
    b1_comp["function_bound_ms"] = bound(COMP_ROWS * len(big_cols) * 5, 0)[0]
    del Xv, Mv
    # where the first compensated measure's wall goes: the f32 describe
    # (moments, one device sort, order statistics) and the compensated moments
    for name, fn in (("describe_numeric", describe_numeric), ("compensated_moments", compensated_moments)):
        timed(torch, out.setdefault("split_s", {}), name, lambda: fn(Xb, Mb))
    print(f"association: the chunk view's build {b1_comp['view_copy_ms']:.4f} ms; the function's "
          f"byte bound {b1_comp['function_bound_ms']:.5f} ms; at {COMP_ROWS} rows describe_numeric "
          f"{out['split_s']['describe_numeric']:.3f} s, compensated_moments "
          f"{out['split_s']['compensated_moments']:.3f} s", flush=True)
    out["kernels"] = {"masked_moments": [b1_comp, b1_mono]}

    # the checks (float64 numpy/pandas)
    t0 = time.perf_counter()
    f32 = {c: df[c].to_numpy(np.float32) for c in num_cols}
    ref = pd.DataFrame({c: f32[c].astype(np.float64) for c in num_cols}).dropna().corr()
    got = corr.set_index("attribute").loc[ref.index, ref.columns].to_numpy()
    out["corr_max_abs_err"] = float(np.abs(got - ref.to_numpy()).max())
    check(out["corr_max_abs_err"] <= 1e-5, f"correlation off float64 by {out['corr_max_abs_err']}")

    ref_ivig = iv_ig_reference(df.drop(columns=[ASSOC_CONFIG["IV_calculation"]["drop_cols"]],
                                       errors="ignore"), "income", ">50K", BIN_SIZE)
    for frame, i, name in ((iv, 0, "iv"), (ig, 1, "ig")):
        gotd = dict(zip(frame["attribute"], frame[name]))
        check(set(gotd) == set(ref_ivig), f"{name} columns {sorted(gotd)}")
        bad = {c: (gotd[c], r[i]) for c, r in ref_ivig.items() if gotd[c] != r[i]}
        check(not bad, f"{name} differs from float64 pandas: {bad}")
    out["iv_max"] = float(iv["iv"].max())

    sample = data_sample(table, fraction=float(VARCLUS_SAMPLE) / table.nrows, method_type="random")
    vc_drop = ASSOC_CONFIG["variable_clustering"]["drop_cols"].split("|")
    vref = varclus_reference(sample, [c for c in num_cols + cat_cols if c not in vc_drop])
    check(vc["Cluster"].tolist() == vref["Cluster"].tolist()
          and vc["Attribute"].tolist() == vref["Attribute"].tolist(),
          f"variable_clustering clusters differ from the float64 VarClus:\n{vc}\n{vref}")
    out["varclus_rs_ratio_max_err"] = float(np.abs(vc["RS_Ratio"] - vref["RS_Ratio"]).max())
    check(out["varclus_rs_ratio_max_err"] <= 1e-3, f"RS_Ratio off by {out['varclus_rs_ratio_max_err']}")
    out["varclus_clusters"] = int(vc["Cluster"].nunique())

    for c in num_cols:
        x = f32[c]
        valid = ~np.isnan(x)
        lo, hi = float(x[valid].min()), float(x[valid].max())
        edges = np.float32(lo + np.arange(1, BIN_SIZE) * ((hi - lo) / BIN_SIZE))
        exp = np.searchsorted(edges, x[valid], side="left") + 1
        check(np.array_equal(binned.columns[c].data.cpu().numpy()[valid], exp), f"equal-range bins of {c}")
    out["monotonic_bins"] = {}
    for c in MONOTONIC_COLS:
        x = f32[c]
        valid = ~np.isnan(x)
        got_b = mono.columns[c].data.cpu().numpy()[valid]
        n = int(got_b.max())
        lo, hi = float(x[valid].min()), float(x[valid].max())
        edges = np.float32(lo + np.arange(1, n) * ((hi - lo) / n))
        check(np.array_equal(got_b, np.searchsorted(edges, x[valid], side="left") + 1),
              f"monotonic bins of {c} ({n} bins)")
        out["monotonic_bins"][c] = n

    for c in cat_cols:
        if c in CAT_TO_NUM_CONFIG["drop_cols"].split("|"):
            continue
        codes = frequency_codes(df[c])
        valid = df[c].notna().to_numpy()
        exp = df[c][valid].astype(str).map(codes).to_numpy()
        col = encoded.columns[c]
        check(col.kind == "num" and np.array_equal(col.data.cpu().numpy()[valid], exp)
              and np.array_equal(col.mask.cpu().numpy(), valid), f"label codes of {c}")

    ex = exact_u.set_index("attribute")["unique_values"]
    ap = approx_u.set_index("attribute")["unique_values"]
    rel = (ap - ex).abs() / ex
    check(bool((rel <= 3 * HLL_RSD).all()), f"approx distinct counts off: {dict(rel)}")
    out["approx_unique_max_rel_err"] = float(rel.max())
    cols_u = list(ap.index)
    Xh = torch.stack([_exact_bits(table.columns[c]) for c in cols_u], dim=1)
    Mh = torch.stack([cat_valid_mask(table.columns[c].data, table.columns[c].mask)
                      if table.columns[c].kind == "cat" else table.columns[c].mask for c in cols_u], dim=1)
    p = precision_for_rsd(HLL_RSD)
    check(torch.equal(hll_registers(Xh, Mh, p).cpu(), hll_registers(Xh.cpu(), Mh.cpu(), p)),
          "HLL registers on the card differ from the CPU's")

    num_out, _ = table_describe(big, big_cols, [])
    plain = {k: v.cpu().numpy() for k, v in masked_moments(Xb, Mb).items()}
    out["compensated_errors"] = check_compensated(num_out, plain, comp_data, big_cols)
    cen = big_frames["measures_of_centralTendency"].set_index("attribute")
    check(all(cen.loc[c, "mean"] == np.round(num_out["mean"][j], 4) for j, c in enumerate(big_cols)),
          "the central tendency frame does not carry the compensated means")
    out["checks_s"] = time.perf_counter() - t0
    print(f"association: correlation within {out['corr_max_abs_err']:.2e} of float64 with TF32 on; "
          f"IV and IG equal to float64 pandas to 4 decimals; VarClus {out['varclus_clusters']} clusters "
          f"as the float64 VarClus (RS_Ratio within {out['varclus_rs_ratio_max_err']:.2e}); bins and "
          f"label codes exact (monotonic bins {out['monotonic_bins']}); approx distinct counts within "
          f"{out['approx_unique_max_rel_err']:.4f} of exact, registers equal to the CPU's; "
          f"compensated moments at {COMP_ROWS} rows within their bands ({out['checks_s']:.1f} s of "
          f"checks)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: time series
# ---------------------------------------------------------------------------
def ts_secs(values) -> np.ndarray:
    """datetime64 or date-string values (no nulls) → int64 epoch seconds."""
    import pandas as pd

    return pd.to_datetime(pd.Series(values)).to_numpy().astype("datetime64[s]").astype(np.int64)


def day_strings(days) -> np.ndarray:
    return np.asarray(days, np.int64).astype("datetime64[D]").astype(str)


def on_card(tables, tensors=()) -> bool:
    return all(c.data.is_cuda and c.mask.is_cuda and (c.exact is None or c.exact.is_cuda)
               for t in tables for c in t.columns.values()) and all(x.is_cuda for x in tensors)


def dst_table():
    """A fixed transition table built on the host: US Eastern time's rule
    (second Sunday of March 07:00 UTC to −4 h, first Sunday of November
    06:00 UTC to −5 h), 2014-2026, as int32 transitions and offsets."""
    def first_sunday(y: int, m: int) -> int:
        d = np.datetime64(f"{y}-{m:02d}-01").astype(np.int64)
        return int(d + (6 - (d + 3) % 7) % 7)  # Mon = 0, Sunday = 6

    tr, off = [], [-18000]
    for y in range(2014, 2027):
        tr += [(first_sunday(y, 3) + 7) * 86400 + 7 * 3600, first_sunday(y, 11) * 86400 + 6 * 3600]
        off += [-14400, -18000]
    return np.asarray(tr, np.int32), np.asarray(off, np.int32)


def f32_equal(csv_values, ref) -> bool:
    """CSV text of f32 values against f32 references, NaN equal to NaN."""
    got = np.asarray(csv_values, np.float64).astype(np.float32)
    ref = np.asarray(ref, np.float64).astype(np.float32)
    return bool(np.array_equal(got, ref, equal_nan=True))


def mean_err(got, ref) -> float:
    """Largest |got − ref| / (1e-4 + 1e-5·|ref|): at most 1 within the band."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ok = ~np.isnan(ref)
    check(bool(np.array_equal(np.isnan(got), ~ok)), "mean nulls differ")
    return float((np.abs(got[ok] - ref[ok]) / (1e-4 + 1e-5 * np.abs(ref[ok]))).max(initial=0.0))


def bucket_reference(X64, key, labels=None):
    """Per-bucket count/min/max/median/mean of every column of ``X64`` in
    the viz files' row order (column, then bucket): a long frame."""
    import pandas as pd

    g = X64.groupby(key)
    stats = {a: getattr(g, a)() for a in ("count", "min", "max", "median", "mean")}
    parts = []
    for c in X64.columns:
        cnt = stats["count"][c]
        keep = cnt.index[cnt > 0]
        parts.append(pd.DataFrame({"bucket": keep if labels is None else [labels[k] for k in keep],
                                   "attribute": c, **{a: stats[a][c][keep].to_numpy() for a in stats}}))
    return pd.concat(parts, ignore_index=True)


def check_viz_frame(got, ref, daily: bool) -> float:
    """A ts_num_* file against ``bucket_reference``: keys and counts exact,
    min/max/median the f32 values rounded to 4 decimals, mean in its band;
    returns the mean's error in band units."""
    key = "date" if daily else "bucket"
    check(len(got) == len(ref) and got[key].astype(str).tolist() == [str(b) for b in ref["bucket"]]
          and got["attribute"].tolist() == ref["attribute"].tolist(), f"{key}s of a viz file")
    check(bool((got["count"].astype(np.int64) == ref["count"]).all()), "viz counts")
    for a in ("min", "max", "median"):
        r32 = ref[a].to_numpy().astype(np.float32)
        exp = (np.round(r32, 4) if daily else [round(float(x), 4) for x in r32])
        check(f32_equal(got[a], exp), f"viz {a}")
    err = mean_err(got["mean"], ref["mean"])
    check(err <= 1, f"viz means off by {err:.3f} of their band")
    return err


def check_ts_files(tmp: str, col: str, secs: np.ndarray, X64, cat_codes: dict) -> dict:
    """Every ts_* file of one ts column against float64 pandas/numpy
    (``X64``: the numeric columns' f32 values as float64; ``cat_codes``:
    the first 10 categorical columns, each as ``pandas.factorize`` codes
    and values)."""
    import pandas as pd

    from anovos_tpu_torch.data_analyzer.ts_analyzer import adf_test, kpss_test, seasonal_decompose_ma

    rd = lambda name: pd.read_csv(os.path.join(tmp, f"{name}_{col}.csv"), keep_default_na=False)  # noqa: E731
    ts = pd.Series(secs.astype("datetime64[s]"))
    day = secs // 86400
    udays, ucnt = np.unique(day, return_counts=True)
    daily = rd("ts_daily")
    check(daily["yyyymmdd_col"].tolist() == day_strings(udays).tolist()
          and daily["count"].tolist() == ucnt.tolist(), f"ts_daily of {col}")
    hour, dow = ts.dt.hour.to_numpy(), ts.dt.dayofweek.to_numpy()
    for name, key, vals in (("ts_hourly", "hour", hour), ("ts_weekly", "dayofweek", dow)):
        k, n = np.unique(vals, return_counts=True)
        f = rd(name)
        check(f[key].tolist() == k.tolist() and f["count"].tolist() == n.tolist(), f"{name} of {col}")
    dp_names = np.array(["late_hours", "early_hours", "work_hours", "evening_hours", "night_hours"])
    dp = np.digitize(hour, [6, 10, 17, 21])
    k, n = np.unique(dp_names[dp], return_counts=True)
    f = rd("ts_daypart")
    check(f["daypart"].tolist() == k.tolist() and f["count"].tolist() == n.tolist(), f"ts_daypart of {col}")

    errs = {}
    ref = bucket_reference(X64, day)
    ref["bucket"] = day_strings(ref["bucket"].to_numpy())
    errs["daily"] = check_viz_frame(rd("ts_num_daily"), ref, daily=True)
    errs["hourly"] = check_viz_frame(rd("ts_num_hourly"), bucket_reference(X64, dp, list(dp_names)), False)
    errs["weekly"] = check_viz_frame(rd("ts_num_weekly"), bucket_reference(
        X64, dow, ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]), False)

    cat = rd("ts_cat_daily")
    check(cat["attribute"].unique().tolist() == list(cat_codes), f"ts_cat_daily columns of {col}")
    d0, nd = udays[0], udays[-1] - udays[0] + 1
    for c, (codes, uniq) in cat_codes.items():
        rows = cat[cat["attribute"] == c]
        vc = np.bincount(codes, minlength=len(uniq))
        top = [x for x in rows["category"].unique() if x != "Others"]
        is_top = np.isin(uniq, top)
        check(len(top) == min(10, len(uniq))
              and vc[is_top].min() >= (vc[~is_top].max() if (~is_top).any() else 0),
              f"top categories of {c} by {col}")
        labels = top + ["Others"]
        lab_of = np.array([labels.index(u) if u in top else len(top) for u in uniq])
        exp = np.bincount((day - d0) * len(labels) + lab_of[codes], minlength=nd * len(labels))
        got = np.zeros(nd * len(labels), np.int64)
        gd = np.array(rows["date"].tolist(), "datetime64[D]").astype(np.int64) - d0
        np.add.at(got, gd * len(labels) + rows["category"].map(labels.index).to_numpy(), rows["count"].to_numpy())
        check(bool(np.array_equal(got, exp)) and len(rows) == np.count_nonzero(exp),
              f"ts_cat_daily of {c} by {col}")

    dec = seasonal_decompose_ma(ucnt, period=7)
    trend, seas, resid = dec
    exp_dec = pd.DataFrame({"date": day_strings(udays), "observed": ucnt, "trend": np.round(trend, 4),
                            "seasonal": np.round(seas, 4), "residual": np.round(resid, 4)})
    with open(os.path.join(tmp, f"ts_decompose_{col}.csv")) as fh:
        check(fh.read() == exp_dec.to_csv(index=False), f"ts_decompose of {col}")
    exp_st = pd.DataFrame([{"attribute": col, **adf_test(ucnt), **kpss_test(ucnt)}])
    with open(os.path.join(tmp, f"ts_stationarity_{col}.csv")) as fh:
        check(fh.read() == exp_st.to_csv(index=False), f"ts_stationarity of {col}")

    stats = pd.read_csv(os.path.join(tmp, "ts_stats.csv")).set_index("attribute").loc[col]
    check(int(stats["eligible"]) == 1 and int(stats["span_days"]) == (secs.max() - secs.min()) // 86400
          and int(stats["distinct_days"]) == len(udays) and float(stats["null_pct"]) == 0.0
          and stats["min_ts"] == str(ts.min()) and stats["max_ts"] == str(ts.max()), f"ts_stats of {col}")
    land = pd.read_csv(os.path.join(tmp, "ts_landscape.csv")).set_index("attribute").loc[col]
    check(int(land["records"]) == len(secs) and int(land["distinct_days"]) == len(udays)
          and float(land["avg_records_per_day"]) == round(len(secs) / len(udays), 2)
          and int(land["max_records_per_day"]) == ucnt.max()
          and float(land["weekend_pct"]) == round(float((dow >= 5).mean()), 4)
          and land["top_daypart"] == pd.Series(dp_names[dp]).mode().iloc[0]
          and land["start"] == str(ts.min()) and land["end"] == str(ts.max()), f"ts_landscape of {col}")
    return errs


def check_ts_aggregate(agg, fmt: str, secs: np.ndarray, X64, num_cols) -> float:
    """An aggregator frame against float64 pandas: counts, min, max and
    median (the f32 mean of two values) exact, sum, mean and stddev within
    1e-5 relative; returns the largest relative error."""
    unit = {"%Y-%m": "datetime64[M]", "%Y-%m-%d": "datetime64[D]"}[fmt]
    key = secs.astype("datetime64[s]").astype(unit)
    g = X64.groupby(key.astype(np.int64))
    check(agg["dt_1"].tolist() == np.unique(key).astype(str).tolist(), f"aggregator {fmt} keys")
    worst = 0.0
    for a in TS_AGGS:
        ref = getattr(g, "std" if a == "stddev" else a)()
        for c in num_cols:
            got, r = agg[f"{c}_{a}"].to_numpy(np.float64), ref[c].to_numpy(np.float64)
            if a in ("count", "min", "max", "median"):
                check(f32_equal(got, r), f"aggregator {fmt} {c}_{a}")
            else:
                ok = ~np.isnan(r)
                check(bool(np.array_equal(np.isnan(got), ~ok)), f"aggregator {fmt} {c}_{a} nulls")
                rel = np.abs(got[ok] - r[ok]) / np.maximum(np.abs(r[ok]), 1e-30)
                worst = max(worst, float(rel.max(initial=0.0)))
    check(worst <= 1e-5, f"aggregator {fmt}: relative error {worst:.3e} above 1e-5")
    return worst


def check_ts_window(out, window_type: str, part: str, secs, df) -> float:
    """window_aggregator's columns against pandas sort_values + rolling /
    expanding: min and max exact, mean within 1e-6 relative."""
    import pandas as pd

    codes = pd.Categorical(df[part]).codes if part else np.zeros(len(secs), np.int8)
    order = np.lexsort((secs, codes))
    got = out.select([f"{c}_{a}_{window_type}" for c in TS_WINDOW_COLS for a in TS_WINDOW_AGGS]).to_pandas()
    worst = 0.0
    for c in TS_WINDOW_COLS:
        s = pd.Series(df[c].to_numpy(np.float32).astype(np.float64)[order])
        grp = s.groupby(codes[order])
        win = grp.rolling(3, min_periods=3) if window_type == "rolling" else grp.expanding(1)
        for a in TS_WINDOW_AGGS:
            ref = np.empty(len(secs))
            ref[order] = getattr(win, a)().reset_index(level=0, drop=True).sort_index().to_numpy()
            g = got[f"{c}_{a}_{window_type}"].to_numpy(np.float64)
            ok = ~np.isnan(ref)
            check(bool(np.array_equal(np.isnan(g), ~ok)), f"window {window_type} {part} {c}_{a} nulls")
            if a == "mean":
                rel = np.abs(g[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1e-30)
                worst = max(worst, float(rel.max(initial=0.0)))
            else:
                check(f32_equal(g, ref), f"window {window_type} {part} {c}_{a}")
    check(worst <= 1e-6, f"window {window_type} {part}: mean off by {worst:.3e}")
    return worst


def phase_timeseries(torch, seed: int, table, df, extra) -> dict:
    """Phase 8 on phase 3's Table with the synthesized rows' ifa, dt_1 and
    dt_2 added (the configs_basic schema)."""
    import pandas as pd

    from anovos_tpu_torch.data_analyzer import ts_analyzer as tsa
    from anovos_tpu_torch.data_ingest.ts_auto_detection import ts_preprocess
    from anovos_tpu_torch.data_transformer import datetime as dt
    from anovos_tpu_torch.ops import datetime_kernels as dk
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.shared.table import host_to_column

    out = {"rows": table.nrows}
    walls = out["walls_s"] = {}
    t0 = time.perf_counter()
    t = table
    for c in TS_EXTRA:  # set-up: the codec dictionary-encodes the string arrays
        t = t.with_column(c, host_to_column(extra[c].array, table.nrows, table.device))
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    num_cols, _, _ = table.attribute_type_segregation()
    tr_h, off_h = dst_table()
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        basic, full = TS_BASIC_CONFIG, TS_FULL_CONFIG
        tsd = timed(torch, walls, "ts_preprocess", lambda: ts_preprocess(
            t, basic["id_col"], output_path=tmp, tz_offset=basic["tz_offset"], run_type="local"))
        timed(torch, walls, "ts_analyzer", lambda: tsa.ts_analyzer(
            tsd, full["id_col"], max_days=full["max_days"], output_path=tmp,
            output_type=full["analysis_level"], tz_offset=full["tz_offset"], run_type="local"))
        aggs = {fmt: timed(torch, walls, f"aggregator {fmt}",
                           lambda: dt.aggregator(tsd, num_cols, list(TS_AGGS), "dt_1", fmt))
                for fmt in TS_FORMATS}
        windows = {(wt, part): timed(torch, walls, f"window_aggregator {wt}{' by ' + part if part else ''}",
                                     lambda: dt.window_aggregator(tsd, list(TS_WINDOW_COLS), list(TS_WINDOW_AGGS),
                                                                  "dt_1", wt, 3, partition_col=part))
                   for wt in ("rolling", "expanding") for part in ("", "workclass")}
        lagged = timed(torch, walls, "lagged_ts", lambda: dt.lagged_ts(
            tsd, "dt_1", lag=1, output_type="ts_diff", tsdiff_unit="days"))
        units = timed(torch, walls, "timeUnits_extraction", lambda: dt.timeUnits_extraction(tsd, "dt_1", "all"))

        def calendar():
            res = {n: getattr(dt, n)(tsd, "dt_2", output_mode="append") for n in TS_SNAPS + TS_PREDICATES}
            res["is_selectedHour"] = dt.is_selectedHour(tsd, "dt_2", 22, 4)
            return res
        cal = timed(torch, walls, "boundaries and predicates (16)", calendar)
        tr, off = torch.from_numpy(tr_h).cuda(), torch.from_numpy(off_h).cuda()
        shifted = timed(torch, walls, "apply_offset_table",
                        lambda: dk.apply_offset_table(tsd["dt_1"].data, tr, off))
        out["launches"] = dict(kernels.LAUNCHES)
        out["seconds"] = sum(walls.values())
        check(all(n == 0 for n in out["launches"].values()),
              f"the time-series path launched kernels: {out['launches']}")
        print("timeseries: walls " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()), flush=True)
        # where ts_analyzer's wall goes, for one of its two columns (after
        # the timed steps): its three parts that reach the card; the rest
        # is host frames, CSV writes and the decomposition
        split = out["ts_analyzer_split_s"] = {}
        _, cat_cols, _ = tsd.attribute_type_segregation()
        cal1 = timed(torch, split, "calendar counts", lambda: tsa._calendar(tsd, "dt_1"))
        timed(torch, split, "numeric viz, 3 grains", lambda: tsa._ts_num_viz_all(tsd, "dt_1", num_cols, cal1))
        timed(torch, split, "categorical viz", lambda: tsa._cat_viz(tsd, "dt_1", cat_cols[:10]))
        print("timeseries: ts_analyzer's parts for dt_1 " + ", ".join(
            f"{k} {v:.3f} s" for k, v in split.items()), flush=True)

        # the checks (float64 pandas/numpy on all rows)
        t0 = time.perf_counter()
        results = [tsd, lagged, units, *windows.values(), *cal.values()]
        check(on_card(results, [shifted]), "a ts function returned a tensor off the card")
        secs = {c: ts_secs(extra[c].to_numpy()) for c in ("dt_1", "dt_2")}
        for c in TS_EXTRA[1:]:
            col = tsd[c]
            check(col.kind == "ts" and bool(col.mask.all()), f"{c} not converted")
            check(bool(np.array_equal(col.data.cpu().numpy().astype(np.int64), secs[c])),
                  f"{c}: seconds differ from pandas.to_datetime")
        check([c for c in tsd.col_names if tsd[c].kind == "ts"] == ["dt_1", "dt_2"]
              and all(tsd[c] is t[c] for c in tsd.col_names if c not in ("dt_1", "dt_2")),
              "ts_preprocess changed another column")
        det = pd.read_csv(os.path.join(tmp, "ts_cols_stats.csv")).set_index("attribute")
        check(set(det.index[det["status"] == "converted"]) == {"dt_1", "dt_2"}
              and (det.loc[["dt_1", "dt_2"], "parsed_fraction"] == 1.0).all(), "ts_cols_stats.csv")
        cat_src = lambda c: extra[c] if c in TS_EXTRA else df[c]  # noqa: E731
        cat_codes = {c: pd.factorize(cat_src(c).astype(str).to_numpy()) for c in cat_cols[:10]}
        X64 = df[num_cols].astype(np.float32).astype(np.float64)
        out["viz_mean_err_band_units"] = {c: check_ts_files(tmp, c, secs[c], X64, cat_codes)
                                          for c in ("dt_1", "dt_2")}
        out["aggregator_max_rel_err"] = {fmt: check_ts_aggregate(aggs[fmt], fmt, secs["dt_1"], X64, num_cols)
                                         for fmt in TS_FORMATS}
        out["window_mean_max_rel_err"] = {f"{wt} {part}".strip(): check_ts_window(w, wt, part, secs["dt_1"], df)
                                          for (wt, part), w in windows.items()}
        s1 = pd.Series(secs["dt_1"])
        srt = s1.sort_values(kind="stable")
        diff = ((srt - srt.shift(1)) / 86400).astype(np.float32).sort_index().to_numpy()
        check(f32_equal(lagged.select(["dt_1_lag1_diff"]).to_pandas()["dt_1_lag1_diff"], diff),
              "lagged_ts against pandas shift")
        ts1 = pd.Series(secs["dt_1"].astype("datetime64[s]"))
        got_u = units.select([c for c in units.col_names if c.startswith("dt_1_")]).to_pandas()
        for u, ref in (("year", ts1.dt.year), ("month", ts1.dt.month), ("day", ts1.dt.day),
                       ("hour", ts1.dt.hour), ("minute", ts1.dt.minute), ("second", ts1.dt.second),
                       ("dayofweek", ts1.dt.dayofweek + 1), ("dayofyear", ts1.dt.dayofyear),
                       ("weekofyear", ts1.dt.isocalendar().week), ("quarter", ts1.dt.quarter)):
            check(bool(np.array_equal(got_u[f"dt_1_{u}"].to_numpy(np.int64), ref.to_numpy(np.int64))),
                  f"timeUnits_extraction {u} against pandas .dt")
        ts2 = pd.Series(secs["dt_2"].astype("datetime64[s]"))
        m = secs["dt_2"].astype("datetime64[s]").astype("datetime64[M]")
        q0 = (m.astype(np.int64) - m.astype(np.int64) % 3).astype("datetime64[M]")
        y0 = m.astype("datetime64[Y]")
        day_s = lambda x: x.astype("datetime64[D]").astype("datetime64[s]")  # noqa: E731
        snaps = {"start_of_month": day_s(m), "end_of_month": day_s(m + 1) - 86400,
                 "start_of_year": day_s(y0), "end_of_year": day_s(y0 + 1) - 86400,
                 "start_of_quarter": day_s(q0), "end_of_quarter": day_s(q0 + 3) - 86400}
        for n, ref in snaps.items():
            col = [c for c in cal[n].col_names if c not in tsd.col_names][0]
            check(bool(np.array_equal(cal[n][col].data.cpu().numpy().astype(np.int64),
                                      ref.astype(np.int64))), f"{n} against numpy")
        preds = {"is_monthStart": ts2.dt.is_month_start, "is_monthEnd": ts2.dt.is_month_end,
                 "is_yearStart": ts2.dt.is_year_start, "is_yearEnd": ts2.dt.is_year_end,
                 "is_quarterStart": ts2.dt.is_quarter_start, "is_quarterEnd": ts2.dt.is_quarter_end,
                 "is_yearFirstHalf": ts2.dt.month <= 6, "is_leapYear": ts2.dt.is_leap_year,
                 "is_weekend": ts2.dt.dayofweek >= 5,
                 "is_selectedHour": (ts2.dt.hour >= 22) | (ts2.dt.hour <= 4)}
        for n, ref in preds.items():
            col = [c for c in cal[n].col_names if c not in tsd.col_names][0]
            check(bool(np.array_equal(cal[n][col].data.cpu().numpy(), ref.to_numpy().astype(np.int32))),
                  f"{n} against pandas")
        idx = np.searchsorted(tr_h, secs["dt_1"], side="right")
        check(bool(np.array_equal(shifted.cpu().numpy().astype(np.int64), secs["dt_1"] + off_h[idx])),
              "apply_offset_table against numpy searchsorted")
        out["checks_s"] = time.perf_counter() - t0
    print(f"timeseries: dt_1 and dt_2 detected and analyzed, every ts file, the aggregator at "
          f"{', '.join(TS_FORMATS)}, 4 window runs, lags, calendar fields, 16 boundaries and "
          f"predicates and the offset table checked against float64 pandas/numpy on {out['rows']} rows "
          f"({out['checks_s']:.1f} s of checks)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: the YAML runner and the basic report
# ---------------------------------------------------------------------------
def basic_config(main_dir: str, join_dir: str) -> dict:
    """BASIC_CONFIG with its two read paths pointed at ``main_dir`` and
    ``join_dir``."""
    import copy

    cfg = copy.deepcopy(BASIC_CONFIG)
    cfg["input_dataset"]["read_dataset"]["file_path"] = main_dir
    cfg["join_dataset"]["dataset1"]["read_dataset"]["file_path"] = join_dir
    return cfg


def runner_reference(full, side_rows):
    """The pandas counterpart of the config's ingest: ``logfnl`` deleted,
    two columns renamed, age and education_num recast to f32, the inner
    join with the side (its age and workclass renamed) on ifa, dt_1 and
    dt_2 parsed by ``pandas.to_datetime``."""
    import pandas as pd

    ref = full.drop(columns=["logfnl"]).rename(
        columns={"marital-status": "marital_status", "education-num": "education_num"})
    for c in ("age", "education_num"):
        ref[c] = ref[c].astype(np.float32).astype(np.float64)
    side = full.iloc[side_rows][["ifa", "age", "workclass"]].rename(
        columns={"age": "dupl_age", "workclass": "dupl_workclass"})
    ref = ref.merge(side, on="ifa", how="inner").sort_values("ifa").reset_index(drop=True)
    for c in ("dt_1", "dt_2"):
        ref[c] = pd.to_datetime(ref[c])
    return ref


class KernelInputs:
    """While in its ``with`` block, records a copy of every argument list
    the kernel wrappers are given through the modules that call them
    (``ops/reductions`` and ``ops/streaming`` for B1, ``ops/drift_kernels``
    for B2), and the host time of the call, then calls the wrapper
    itself: the inputs a path gave each kernel, to hold it against its
    plain version after the path ran, and when it ran."""

    SITES = (("reductions", "masked_moments_cols", "masked_moments"),
             ("streaming", "masked_moments_cols", "masked_moments"),
             ("drift_kernels", "binned_histograms_cols", "binned_histograms"))

    def __init__(self, torch):
        import importlib

        self.torch = torch
        self.seen = {"masked_moments": [], "binned_histograms": []}
        self.times = {"masked_moments": [], "binned_histograms": []}
        self.sites = [(importlib.import_module(f"anovos_tpu_torch.ops.{m}"), attr, name)
                      for m, attr, name in self.SITES]
        self.saved = []

    def __enter__(self):
        def recorder(fn, name):
            def call(*args):
                self.seen[name].append(tuple(a.clone() if self.torch.is_tensor(a) else a for a in args))
                self.times[name].append(time.perf_counter())
                return fn(*args)
            return call

        for mod, attr, name in self.sites:
            self.saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, recorder(getattr(mod, attr), name))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        self.saved = []


def check_runner_files(ref, rdir: str) -> int:
    """Every file the basic report writes: its 17 CSVs, a ``freqDist_``
    chart for each numeric and string column but the id, an ``eventDist_``
    chart for each but the id and the label, and the HTML."""
    from anovos_tpu_torch.data_report.basic_report_generation import QUALITY_FUNCS, STATS_FUNCS

    cols = [c for c in ref.columns if c != "ifa" and ref[c].dtype.kind != "M"]
    want = ([f + ".csv" for f in STATS_FUNCS + QUALITY_FUNCS
             + ("IV_calculation", "IG_calculation", "data_type")]
            + ["freqDist_" + c for c in cols] + ["eventDist_" + c for c in cols if c != "income"]
            + ["ml_anovos_report.html"])
    missing = [f for f in want if not os.path.exists(os.path.join(rdir, f))]
    check(not missing, f"the basic report did not write {missing}")
    return len(want)


def check_runner_stats(ref, rdir: str, id_col: str = "ifa", measures: int = 7) -> None:
    """The report's stats CSVs against float64 pandas, with phase 3's bands
    (``check_stats``): all seven, or with ``measures`` 3 only
    global_summary, measures_of_counts and measures_of_centralTendency,
    with 4 those and measures_of_cardinality."""
    import pandas as pd

    read = lambda name: pd.read_csv(os.path.join(rdir, name + ".csv"))  # noqa: E731
    cols = [c for c in ref.columns if c != id_col]
    num_cols = [c for c in cols if ref[c].dtype.kind in "fiu"]
    cat_cols = [c for c in cols if pd.api.types.is_string_dtype(ref[c])]
    summary = dict(zip(read("global_summary")["metric"], read("global_summary")["value"]))
    check(int(float(summary["rows_count"])) == len(ref) and int(float(summary["columns_count"])) == len(cols),
          f"global_summary {summary}")
    counts = read("measures_of_counts").set_index("attribute")
    check(sorted(counts.index) == sorted(cols), "measures_of_counts columns")
    for c in cols:
        check(int(counts.loc[c, "fill_count"]) == int(ref[c].notna().sum()), f"fill_count of {c}")
    cen = read("measures_of_centralTendency").set_index("attribute")
    for c in num_cols:
        v = ref[c].dropna().to_numpy(np.float64)
        if not len(v):  # the all-null column: no moments
            check(bool(np.isnan(cen.loc[c, "mean"])), f"mean of the all-null {c}")
            continue
        m = v.mean()
        check(abs(cen.loc[c, "mean"] - m) <= 1e-4 + 1e-5 * abs(m), f"mean of {c}: {cen.loc[c, 'mean']} vs {m}")
    for c in cat_cols:
        vc = ref[c].dropna().astype(str).value_counts()
        best = sorted(vc.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        check(cen.loc[c, "mode"] == best[0] and int(cen.loc[c, "mode_rows"]) == best[1], f"mode of {c}")
    if measures == 3:
        return
    card = read("measures_of_cardinality").set_index("attribute")
    for c in num_cols + cat_cols:
        exp = ref[c].dropna().astype(str).nunique() if c in cat_cols else ref[c].nunique()
        check(int(card.loc[c, "unique_values"]) == int(exp), f"unique_values of {c}")
    if measures == 4:
        return
    disp = read("measures_of_dispersion").set_index("attribute")
    pct = read("measures_of_percentiles").set_index("attribute")
    shape = read("measures_of_shape").set_index("attribute")
    for c in num_cols:
        v = ref[c].dropna().to_numpy(np.float64)
        if not len(v):
            continue
        m, sd = v.mean(), v.std(ddof=1)
        check(abs(disp.loc[c, "stddev"] - sd) <= 1e-4 + 1e-4 * sd, f"stddev of {c}")
        check(pct.loc[c, "min"] == np.round(v.min(), 4) and pct.loc[c, "max"] == np.round(v.max(), 4),
              f"min/max of {c}")
        d = v - m
        m2 = (d ** 2).mean()
        ref_shape = {"skewness": (d ** 3).mean() / m2 ** 1.5, "kurtosis": (d ** 4).mean() / m2 ** 2 - 3}
        for k, exp in ref_shape.items():
            check(abs(shape.loc[c, k] - exp) <= 2e-3 + 2e-3 * abs(exp), f"{k} of {c}: {shape.loc[c, k]} vs {exp}")


def check_runner_quality(ref, rdir: str) -> dict:
    """The basic report's quality CSVs: duplicates, null rows and IDness
    against pandas, each outlier count inside the counts of fences 1% off
    the float64 fence, invalid entries against the auto rules' reference."""
    import pandas as pd

    from anovos_tpu_torch.data_analyzer.quality_checker import _DEFAULT_DETECTION

    read = lambda name: pd.read_csv(os.path.join(rdir, name + ".csv"), keep_default_na=False,  # noqa: E731
                                    na_values=[""])
    body = ref.drop(columns=["ifa"])
    as_str = lambda col: col.astype(str).where(col.notna()) if col.dtype.kind not in "fiu" else col  # noqa: E731
    dup = read("duplicate_detection").set_index("metric")["value"]
    check(int(dup["duplicate_rows"]) == int(body.duplicated().sum()) == 0, f"duplicates {dict(dup)}")
    nr = read("nullRows_detection")
    exp = body.isna().sum(axis=1).value_counts().sort_index()
    check(nr["null_cols_count"].tolist() == exp.index.tolist() and nr["row_count"].tolist() == exp.tolist(),
          "nullRows counts differ from pandas")
    nc = read("nullColumns_detection").set_index("attribute")  # the columns with a null
    has_null = [c for c in body.columns if body[c].isna().any()]
    check(sorted(nc.index) == sorted(has_null), f"nullColumns columns {sorted(nc.index)} vs {has_null}")
    for c in has_null:
        miss = int(body[c].isna().sum())
        check(int(nc.loc[c, "missing_count"]) == miss
              and abs(nc.loc[c, "missing_pct"] - miss / len(body)) <= 5e-5 + 1e-12, f"nullColumns of {c}")
    bias = read("biasedness_detection")
    check(len(bias) > 0, "biasedness_detection is empty")
    for _, r in bias.iterrows():
        vc = as_str(body[r["attribute"]]).value_counts()
        if vc.empty:  # the all-null column: no mode
            check(int(r["mode_rows"]) == 0 and np.isnan(r["mode_pct"]), f"biasedness of {r['attribute']}")
            continue
        check(int(r["mode_rows"]) == int(vc.max())
              and abs(r["mode_pct"] - vc.max() / vc.sum()) <= 5e-5 + 1e-12, f"biasedness of {r['attribute']}")
    for _, r in read("IDness_detection").iterrows():
        col = as_str(body[r["attribute"]])
        n = col.notna().sum()
        check(int(r["unique_values"]) == col.nunique()
              and (n == 0 or abs(r["IDness"] - col.nunique() / n) <= 5e-5 + 1e-12),
              f"IDness of {r['attribute']}")
    out = {"outlier_upper": {}}
    got = read("outlier_detection").set_index("attribute")["upper_outliers"]
    for c in [c for c in body.columns if body[c].dtype.kind == "f"]:
        v = body[c].dropna().to_numpy(np.float64)
        if not len(v):  # the all-null column: nothing to flag
            check(int(got.get(c, 0)) == 0, f"outliers in the all-null {c}")
            continue
        hi = upper_bound_f64(v, _DEFAULT_DETECTION)
        if hi is None:
            check(c not in got.index, f"outlier: {c} not skewed in float64")
            continue
        x = v.astype(np.float32)
        lo_n, hi_n = int((x > hi + 0.01 * abs(hi)).sum()), int((x > hi - 0.01 * abs(hi)).sum())
        check(lo_n <= int(got[c]) <= hi_n, f"outlier count of {c}: {got[c]} outside [{lo_n}, {hi_n}]")
        out["outlier_upper"][c] = int(got[c])
    out["invalid"] = {}
    for _, r in read("invalidEntries_detection").iterrows():
        c = r["attribute"]
        entries = r["invalid_entries"]
        bad = [b for b in entries.split("|") if b] if isinstance(entries, str) else []
        check(all(auto_invalid(b) for b in bad), f"invalid entries of {c}: {bad[:5]}")
        col = body[c]
        if col.dtype.kind == "f":
            x = col.dropna().to_numpy(np.float32)
            n = int(np.isin(x, np.array(bad, np.float64).astype(np.float32)).sum())
        else:
            vc = col.dropna().astype(str).value_counts()
            n = int(sum(k for v, k in vc.items() if auto_invalid(v)))
            check(n == int(col.isin(bad).sum()), f"invalid entries of {c} miss a value")
        check(n == int(r["invalid_count"]), f"invalid count of {c}: {r['invalid_count']} vs {n}")
        if n:
            out["invalid"][c] = n
    return out


def check_runner_charts(ref, rdir: str) -> int:
    """Every numeric freqDist_ chart's counts equal to a numpy digitize of
    the column's f32 values against the cutoffs the chart used (numpy's
    'lower' deciles); the all-null column's all zero."""
    n = 0
    for c in ref.columns:
        if ref[c].dtype.kind != "f" or c == "income":
            continue
        with open(os.path.join(rdir, "freqDist_" + c)) as f:
            got = json.load(f)["data"][0]["y"]
        x = ref[c].dropna().to_numpy(np.float32)
        if len(x):
            edges = np.quantile(x, [j / BIN_SIZE for j in range(1, BIN_SIZE)], method="lower")
            exp = np.bincount(np.searchsorted(edges.astype(np.float32), x, side="left"), minlength=BIN_SIZE)
        else:
            exp = np.zeros(BIN_SIZE, np.int64)
        check([float(v) for v in exp] == got, f"freqDist_{c}: {got} vs {exp.tolist()}")
        n += 1
    check(n > 0, "no numeric chart checked")
    return n


def check_runner_event_charts(ref, rdir: str, label: str, event: str) -> int:
    """Every ``eventDist_`` chart's rates within 1e-6 of float64 label
    counts over the rows whose label is valid: a numeric column's bins by a
    numpy digitize against the same deciles as its ``freqDist_`` chart, a
    string column's categories by pandas."""
    import pandas as pd

    valid = ref[label].notna().to_numpy()
    y = (ref[label] == event).to_numpy()[valid]
    n = 0
    for c in ref.columns:
        if c in ("ifa", label) or ref[c].dtype.kind == "M":
            continue
        with open(os.path.join(rdir, "eventDist_" + c)) as f:
            data = json.load(f)["data"][0]
        col = ref[c][valid]
        have = col.notna().to_numpy()
        if ref[c].dtype.kind == "f":
            x = ref[c].dropna().to_numpy(np.float32)
            rate = np.zeros(BIN_SIZE)
            if len(x):
                edges = np.quantile(x, [j / BIN_SIZE for j in range(1, BIN_SIZE)], method="lower")
                b = np.searchsorted(edges.astype(np.float32), col.to_numpy(np.float32)[have], side="left")
                tot = np.bincount(b, minlength=BIN_SIZE)
                rate = np.where(tot > 0, np.bincount(b, weights=y[have], minlength=BIN_SIZE) / np.maximum(tot, 1), 0)
            exp = dict(zip([str(j + 1) for j in range(BIN_SIZE)], rate))
        else:  # every category of the column, 0 where no row has a valid label
            rate = pd.Series(y[have], dtype=np.float64).groupby(col[have].astype(str).to_numpy()).mean()
            exp = {k: float(rate.get(k, 0.0)) for k in ref[c].dropna().astype(str).unique()}
        got = dict(zip(data["x"], data["y"]))
        check(len(got) == len(data["x"]) and set(got) == set(exp),
              f"eventDist_{c}: bins {sorted(got)[:5]} vs {sorted(exp)[:5]}")
        bad = [k for k in exp if abs(got[k] - exp[k]) > 1e-6]
        check(not bad, f"eventDist_{c}: rates of {bad[:5]} differ from float64")
        n += 1
    return n


def tree_digest(root: str, skip=("obs",)) -> dict:
    """{relative path: sha1} of every file a run wrote under ``root``
    (``skip``'s directories left out; ``obs/`` records the run, not the
    pipeline)."""
    import hashlib

    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if x not in skip)
        for f in sorted(files):
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(fh.read()).hexdigest()
    return out


def schedule(summary: dict) -> dict:
    """The parts of ``workflow.LAST_RUN_SUMMARY`` a phase prints and
    compares: the mode, walls, critical path, speedup and each node's
    dependencies and stream."""
    keep = ("mode", "workers", "multidev_overlap", "wall_s", "serial_s", "critical_path_s",
            "parallel_speedup", "critical_path")
    return {**{k: summary[k] for k in keep},
            "deps": {n: v["deps"] for n, v in summary["nodes"].items()},
            "on_stream": sorted(n for n, v in summary["nodes"].items() if v["stream"])}


def run_measured(torch, cfg: dict, run_dir: str) -> dict:
    """``workflow.main(cfg)`` in ``run_dir`` (made here): the wall, the
    kernel launches it made, block walls, schedule, the peak device memory
    above what was allocated before it, and the digest of every file it
    wrote."""
    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.ops import kernels

    os.makedirs(run_dir)
    cwd = os.getcwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(kernels.LAUNCHES)
    os.chdir(run_dir)
    try:
        t0 = time.perf_counter()
        workflow.main(cfg, "local")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    return {"wall_s": wall, "launches": {k: kernels.LAUNCHES[k] - before[k] for k in before},
            "block_times_s": workflow.block_times(), "schedule": schedule(workflow.LAST_RUN_SUMMARY),
            "manifest_path": workflow.LAST_MANIFEST_PATH,
            "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
            "degraded": workflow.degraded_sections(), "tree": tree_digest(run_dir)}


def print_schedule(what: str, run: dict) -> None:
    s = run["schedule"]
    print(f"{what}: scheduler[{s['mode']}] workers {s['workers']}, wall {s['wall_s']:.3f} s, serial "
          f"{s['serial_s']:.3f} s, critical path {s['critical_path_s']:.3f} s "
          f"({' -> '.join(s['critical_path'])}), speedup {s['parallel_speedup']:.3f}x, at most "
          f"{s['multidev_overlap']} nodes at once, {len(s['on_stream'])} of {len(s['deps'])} nodes on CUDA "
          f"streams; peak device memory {run['peak_mib']:.1f} MiB", flush=True)


def runner_inputs(torch, seed: int, root: str):
    """Phase 9's input under ``root``: RUNNER_ROWS synthesized rows as
    parquet and RUNNER_SIDE_ROWS rows' ifa/age/workclass as avro.
    Returns (the frame, the side's rows, main dir, join dir)."""
    from examples._data import synthesize
    from anovos_tpu_torch.data_ingest.data_ingest import write_dataset
    from anovos_tpu_torch.shared.table import Table

    full = synthesize(RUNNER_ROWS, seed=seed + 9)
    side_rows = np.arange(0, RUNNER_ROWS, RUNNER_ROWS // RUNNER_SIDE_ROWS)
    main_dir, join_dir = os.path.join(root, "income"), os.path.join(root, "join")
    os.makedirs(main_dir)
    full.to_parquet(os.path.join(main_dir, "part-00000.parquet"), index=False)
    side = Table.from_pandas(full.iloc[side_rows][["ifa", "age", "workclass"]].reset_index(drop=True))
    write_dataset(side, join_dir, "avro")
    torch.cuda.synchronize()
    return full, side_rows, main_dir, join_dir


def phase_runner(torch, seed: int, root: str) -> dict:
    """Phase 9: ``workflow.main`` on configs_basic.yaml's blocks in the
    runner's default executor mode, its input (``runner_inputs``) and its
    working directory under ``root``, which the caller keeps for phase 15;
    then B1 and B2 on the inputs the runner gave them."""
    import pandas as pd

    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.ops import kernels

    out = {"rows": RUNNER_ROWS, "side_rows": RUNNER_SIDE_ROWS}
    t0 = time.perf_counter()
    full, side_rows, main_dir, join_dir = runner_inputs(torch, seed, root)
    out.update(main_dir=main_dir, join_dir=join_dir, setup_s=time.perf_counter() - t0)
    run_dir = os.path.join(root, "run")
    kernels.reset_launches()
    with KernelInputs(torch) as given, executor(None):
        run = run_measured(torch, basic_config(main_dir, join_dir), run_dir)
    out.update(run)
    print("runner: block walls " + ", ".join(f"{k} {v:.3f} s" for k, v in out["block_times_s"].items())
          + f"; workflow.main {out['wall_s']:.3f} s", flush=True)
    print_schedule("runner", run)
    print(f"runner: kernel launches {out['launches']}", flush=True)
    for name in PATH_KERNELS["runner"]:
        check(out["launches"][name] > 0, f"kernel {name} was not launched by the runner")
    check(workflow.degraded_sections() == {}, f"runner blocks failed: {workflow.degraded_sections()}")
    check(list(out["block_times_s"]) == ["join_dataset", "timeseries_analyzer", "Basic Report"],
          f"runner blocks {list(out['block_times_s'])}")

    # after the run (not counted): each kernel on the inputs the runner
    # gave it, against its plain version, timed
    for name, calls in given.seen.items():
        check(len(calls) == out["launches"][name], f"{name}: {len(calls)} calls recorded, "
              f"{out['launches'][name]} launches")
    out["kernels"] = {
        "masked_moments": [b1_row(torch, Xc, Mc, "runner", f"launch {i + 1} of {len(given.seen['masked_moments'])}")
                           for i, (Xc, Mc) in enumerate(given.seen["masked_moments"])],
        "binned_histograms": [b2_row(torch, Xc, Mc, cuts, nbins, "runner", "the numeric charts")
                              for Xc, Mc, cuts, nbins in given.seen["binned_histograms"]]}
    del given

    # the checks (float64 pandas/numpy)
    t0 = time.perf_counter()
    ref = runner_reference(full, side_rows)
    del full
    rdir = os.path.join(run_dir, "report_stats")
    final = pd.read_parquet(os.path.join(run_dir, "output", "final_dataset"))
    final = final.sort_values("ifa").reset_index(drop=True)
    for c in ("dt_1", "dt_2"):
        final[c] = final[c].astype("datetime64[s]").astype(np.int64)
        ref[c] = ref[c].astype("datetime64[s]")
    try:
        pd.testing.assert_frame_equal(
            final, ref.assign(dt_1=ref["dt_1"].astype(np.int64), dt_2=ref["dt_2"].astype(np.int64)),
            check_dtype=False)
    except AssertionError as e:
        fail(f"runner: final_dataset differs from the pandas inner join: {e}")
    out["joined_rows"] = len(final)
    del final
    det = pd.read_csv(os.path.join(run_dir, "ts_cols_stats.csv")).set_index("attribute")
    check(set(det.index[det["status"] == "converted"]) == {"dt_1", "dt_2"}
          and (det.loc[["dt_1", "dt_2"], "parsed_fraction"] == 1.0).all(), "ts_cols_stats.csv")
    out["files_checked"] = check_runner_files(ref, rdir)
    check_runner_stats(ref, rdir)
    out.update(check_runner_quality(ref, rdir))
    ivs = pd.read_csv(os.path.join(rdir, "IV_calculation.csv")).set_index("attribute")["iv"]
    igs = pd.read_csv(os.path.join(rdir, "IG_calculation.csv")).set_index("attribute")["ig"]
    iv_cols = [c for c in ref.columns if c not in ("ifa", "dt_1", "dt_2", "empty")]
    iv_ref = iv_ig_reference(ref[iv_cols], "income", ">50K", BIN_SIZE)
    check(sorted(ivs.index) == sorted(list(iv_ref) + ["empty"]), "IV columns")
    for c, (iv, ig) in iv_ref.items():
        check(round(float(ivs[c]), 4) == iv and round(float(igs[c]), 4) == ig,
              f"IV/IG of {c}: {ivs[c]}, {igs[c]} vs {iv}, {ig}")
    check(ivs["empty"] == 0 and igs["empty"] == 0, "IV/IG of the all-null column")
    out["charts_checked"] = check_runner_charts(ref, rdir)
    out["event_charts_checked"] = check_runner_event_charts(ref, rdir, "income", ">50K")
    with open(os.path.join(rdir, "ml_anovos_report.html")) as f:
        html = f.read()
    check(html.count("onclick='showTab(") == len(BASIC_TABS)
          and all(f">{t}</button>" in html for t in BASIC_TABS), "the report's tabs")
    out["checks_s"] = time.perf_counter() - t0
    print(f"runner: configs_basic on {RUNNER_ROWS} rows joined with {RUNNER_SIDE_ROWS} avro rows "
          f"({out['joined_rows']} rows profiled): {out['files_checked']} files written; stats, quality, "
          f"IV/IG, {out['charts_checked']} numeric frequency charts, {out['event_charts_checked']} "
          f"event-rate charts, dt_1/dt_2, the report's {len(BASIC_TABS)} tabs and the final dataset "
          f"checked ({out['checks_s']:.1f} s of checks)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: the transformers, the latent features, the model imputers and
# configs_full through the runner
# ---------------------------------------------------------------------------
def full_config(main_dir: str, si_dirs) -> dict:
    """FULL_CONFIG with its read paths pointed at ``main_dir`` (input and
    drift source) and the four stability ``si_dirs``."""
    import copy

    cfg = copy.deepcopy(FULL_CONFIG)
    cfg["input_dataset"]["read_dataset"]["file_path"] = main_dir
    cfg["drift_detector"]["drift_statistics"]["source_dataset"]["read_dataset"]["file_path"] = main_dir
    for i, d in enumerate(si_dirs):
        cfg["drift_detector"]["stability_index"][f"dataset{i + 1}"]["read_dataset"]["file_path"] = d
    return cfg


def tables_equal(torch, a, b) -> bool:
    """Same columns, kinds, types, vocabularies, values and masks, bit for
    bit."""
    if a.col_names != b.col_names or a.nrows != b.nrows:
        return False
    for name in a.col_names:
        x, y = a.columns[name], b.columns[name]
        if (x.kind, x.dtype_name, x.data.dtype) != (y.kind, y.dtype_name, y.data.dtype):
            return False
        if (x.vocab is None) != (y.vocab is None) or (x.vocab is not None and list(x.vocab) != list(y.vocab)):
            return False
        if not (torch.equal(x.data, y.data) and torch.equal(x.mask, y.mask)):
            return False
    return True


def host_values(col) -> np.ndarray:
    """A numeric column as float64 on the host, NaN where masked."""
    v = col.data.to(dtype=col.data.dtype).cpu().numpy().astype(np.float64)
    v[~col.mask.cpu().numpy()] = np.nan
    return v


def keep_set_reference(s, coverage: float, max_category: int):
    """outlier_categories' keep set in float64 pandas: the values by count
    (ties by value), kept while the share before them is under the
    coverage, at most max_category − 1; and whether a cumulative share lies
    within 1e-6 of the coverage (f32 could then decide otherwise)."""
    vc = s.dropna().astype(str).value_counts()
    vc = vc.sort_index().sort_values(ascending=False, kind="stable")
    cum = (vc / vc.sum()).cumsum().to_numpy()
    lag = np.concatenate([[0.0], cum[:-1]])
    sel = ~((cum >= coverage) & (lag >= coverage)) & (np.arange(len(vc)) <= max_category - 2)
    return set(vc.index[sel]), bool((np.abs(cum - coverage) < 1e-6).any())


def check_chain(df, steps: dict, tmp: str) -> dict:
    """The six configs_full transformer steps against float64 pandas/numpy
    over all rows (see the module docstring, phase 10a)."""
    import pandas as pd

    out = {}
    cfg = FULL_CONFIG["transformers"]
    # feature_transformation (sqrt): values within one ulp of the float64
    # root of the f32 value, nulls where the input is null or negative
    sq = steps["feature_transformation"]
    worst = 0.0
    for c in sq.attribute_type_segregation()[0]:
        x = df[c].to_numpy(np.float64).astype(np.float32).astype(np.float64)
        with np.errstate(invalid="ignore"):
            exp = np.sqrt(x).astype(np.float32)
        col = sq.columns[c]
        valid = ~np.isnan(exp)
        check(np.array_equal(col.mask.cpu().numpy(), valid), f"sqrt nulls of {c}")
        got = col.data.cpu().numpy()[valid]
        err = np.abs(got.astype(np.float64) - exp[valid]) / np.spacing(exp[valid]).astype(np.float64)
        worst = max(worst, float(err.max()) if err.size else 0.0)
    check(worst <= 1.0, f"sqrt off the float64 root by {worst} ulps")
    out["sqrt_max_ulps"] = worst
    # outlier_categories: the keep sets
    oc = cfg["categorical_outliers"]["outlier_categories"]
    near = []
    binned = steps["attribute_binning"]
    oc_out = steps["outlier_categories"]
    oc_cols = [c for c in binned.attribute_type_segregation()[1] if c not in oc["drop_cols"]]
    for c in oc_cols:
        ref, tie = keep_set_reference(df[c], oc["coverage"], oc["max_category"])
        got = set(oc_out.columns[c].vocab) - {"outlier_categories"}
        if tie:
            near.append(c)
            continue
        check(got == ref, f"outlier_categories keep set of {c}: {sorted(got)} vs {sorted(ref)}")
    out["keep_sets_checked"] = len(oc_cols) - len(near)
    out["keep_sets_near_coverage"] = near
    # cat_to_num_supervised: rates equal to a pandas groupby mean at 4
    # decimals, as f32 (rates within 1e-3 of a 4-decimal tie in 1e4 units,
    # which an f32 quotient may round the other way, are counted apart)
    sup = steps["cat_to_num_supervised"]
    lab = df["income"]
    ties, checked = 0, 0
    for c in [c for c in oc_cols if c in sup.columns and sup.columns[c].kind == "num"]:
        kept = set(oc_out.columns[c].vocab) - {"outlier_categories"}
        mapped = df[c].astype(str).where(df[c].isin(kept), "outlier_categories").where(df[c].notna())
        ok = mapped.notna() & lab.notna()
        means = (lab[ok] == ">50K").groupby(mapped[ok]).mean()
        present = mapped.dropna()
        enc = sup.columns[c].data.cpu().numpy()
        for i, v in present.groupby(present, sort=False).head(1).items():
            t = means[v] * 1e4
            if abs(t - np.floor(t) - 0.5) < 1e-3:
                ties += 1
                continue
            check(enc[i] == np.float32(np.round(means[v], 4)), f"supervised rate of {c}={v}: {enc[i]} vs {means[v]}")
            checked += 1
    out["rates_checked"], out["rates_near_tie"] = checked, ties
    # IQR_standardization: median and IQR exactly numpy's 'lower' quantiles
    iqr_in = steps["cat_to_num_supervised"]
    m = pd.read_parquet(os.path.join(tmp, "chain", "IQR_standardization", "part-00000.parquet")).set_index("attribute")
    skipped = []
    for c in iqr_in.attribute_type_segregation()[0]:
        v = host_values(iqr_in.columns[c]).astype(np.float32)
        v = v[~np.isnan(v)]
        if not v.size:  # an all-null column: NaN parameters, skipped
            check(np.isnan(m.loc[c, "iqr"]), f"IQR of the all-null {c}")
            skipped.append(c)
            continue
        q = np.quantile(v, [0.25, 0.5, 0.75], method="lower")
        check(m.loc[c, "median"] == q[1] and m.loc[c, "iqr"] == np.float32(q[2] - q[0]),
              f"IQR parameters of {c}: {m.loc[c, 'median']}, {m.loc[c, 'iqr']} vs {q}")
        if q[2] == q[0]:
            skipped.append(c)
    got_skipped = [c for c in m.index if c not in steps["IQR_standardization"].columns
                   or steps["IQR_standardization"].columns[c] is iqr_in.columns[c]]
    check(sorted(got_skipped) == sorted(skipped), f"zero-IQR columns {got_skipped} vs {skipped}")
    out["iqr_zero_skipped"] = skipped
    out.update(check_pca(steps["IQR_standardization"], steps["PCA_latentFeatures"], tmp,
                         cfg["numerical_latentFeatures"]["PCA_latentFeatures"]["explained_variance_cutoff"]))
    return out


def check_pca(pca_in, pca_out, tmp: str, cutoff: float) -> dict:
    """PCA against float64 numpy on all rows: the nulls filled with the
    column median (0 for an all-null column), centred, the covariance's eigenvectors; k equal where no
    cumulative share lies within 1e-4 of the cutoff; each kept component
    within 1 − 1e-4 of the span of the float64 eigenvectors whose
    eigenvalues lie within 1% of its own (its own eigenvector alone where
    no other does: then the bound is |cos| ≥ 1 − 1e-4); the projections
    onto the port's components within 1e-5 of the column's largest |z| of
    their float64 product."""
    import pandas as pd

    cols = pca_in.attribute_type_segregation()[0]
    X = np.stack([host_values(pca_in.columns[c]) for c in cols], 1).astype(np.float32).astype(np.float64)
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        med = np.nan_to_num(np.nanmedian(X, axis=0))  # an all-null column: 0
    X = np.where(np.isnan(X), med[None, :], X)
    X -= X.mean(axis=0)
    ev, vec = np.linalg.eigh(X.T @ X / (len(X) - 1))
    ev, vec = ev[::-1], vec[:, ::-1]
    ratio = np.cumsum(ev) / ev.sum()
    k_ref = int(np.searchsorted(ratio, cutoff) + 1)
    m = pd.read_parquet(os.path.join(tmp, "chain", "PCA_latentFeatures", "part-00000.parquet"))
    V = np.stack([np.asarray(r, np.float64) for r in m["loadings"]], 1)
    k = V.shape[1]
    if np.abs(ratio - cutoff).min() > 1e-4:
        check(k == k_ref, f"PCA k {k} vs float64 {k_ref}")
    cos = np.abs((V * vec[:, :k]).sum(0)) / np.linalg.norm(V, axis=0)
    # f32's rounding of the covariance (|E| ~ 1e-6 relative) turns an
    # eigenvector by up to |E| / gap (Davis-Kahan), so among eigenvalues a
    # few 1e-4 apart (the i.i.d. standardized decile columns' variances)
    # only the cluster's span is determined: each component is held to the
    # float64 eigenvectors within 1% of its eigenvalue, whose span the
    # perturbation turns by |E| / (the gap outside them, >= 1%)
    near = np.abs(ev[None, :] - ev[:k, None]) <= 1e-2 * np.abs(ev[:k, None])
    span = np.array([np.linalg.norm(vec[:, near[i]].T @ V[:, i]) for i in range(k)]) / np.linalg.norm(V, axis=0)
    check(bool((span >= 1 - 1e-4).all()),
          f"PCA components off the span of float64's within 1% of their eigenvalues: {span} (|cos| {cos})")
    # the projections onto the port's own components, in float64: what is
    # left is the f32 centring and product (a component's turn away from
    # float64's, bounded by the |cos| check, moves a projection by up to
    # sin θ · |x|: the near-equal variances of the standardized decile
    # columns leave the eigenvalues close together)
    Z = X @ V
    worst = turned = 0.0
    for i in range(k):
        got = pca_out.columns[f"latent_{i}"].data.cpu().numpy().astype(np.float64)
        worst = max(worst, float(np.abs(got - Z[:, i]).max() / np.abs(Z[:, i]).max()))
        ref = X @ vec[:, i]
        turned = max(turned, float(np.abs(np.sign((got * ref).sum()) * got - ref).max() / np.abs(ref).max()))
    check(worst <= 1e-5, f"PCA projections off float64 by {worst} of the column's largest |z|")
    return {"pca_k": k, "pca_cols": len(cols), "pca_min_cos": float(cos.min()), "pca_min_span_cos": float(span.min()),
            "pca_cluster_sizes": [int(r.sum()) for r in near], "pca_proj_rel_err": worst,
            "pca_proj_vs_float64_components": turned}


def boxcox_reference(torch, table, cols) -> tuple:
    """The boxcox λ search in float64 on the card: for each λ of the grid
    the KS statistic of the transformed valid values against N(0, 1).
    Returns (argmin λ per column, margin to the runner-up)."""
    from anovos_tpu_torch.data_transformer.transformers import _BOXCOX_LAMBDAS

    X, M = table.numeric_block(cols, dtype=torch.float64)
    ks_all = []
    for lam in _BOXCOX_LAMBDAS:
        Y = torch.log(X) if lam == 0.0 else torch.sign(X) * torch.pow(torch.abs(X), lam)
        ok = M & torch.isfinite(Y)
        Yc, okc = torch.where(ok, Y, 0.0).t(), ok.t()
        n = okc.sum(dim=1).to(torch.float64)
        mean = Yc.sum(dim=1) / torch.clamp_min(n, 1)
        d = torch.where(okc, Yc - mean[:, None], 0.0)
        std = torch.sqrt((d * d).sum(dim=1) / torch.clamp_min(n - 1, 1))
        Z = torch.sort(torch.where(okc, (Yc - mean[:, None]) / torch.clamp_min(std, 1e-300)[:, None],
                                   float("inf")), dim=1).values
        pos = torch.arange(1, Z.shape[1] + 1, dtype=torch.float64, device=Z.device)[None, :]
        cdf = torch.special.ndtr(Z)
        n1 = torch.clamp_min(n, 1)[:, None]
        dev = torch.maximum((cdf - pos / n1).abs(), (cdf - (pos - 1) / n1).abs())
        ks_all.append(torch.where(pos <= n[:, None], dev, 0.0).amax(dim=1).cpu().numpy())
    ks = np.stack(ks_all)
    best = np.argmin(ks, axis=0)  # first λ on ties, as the search takes it
    srt = np.sort(ks, axis=0)
    return np.array(_BOXCOX_LAMBDAS)[best], srt[1] - srt[0]


STATE_CASES = (
    ("attribute_binning", {"list_of_cols": ["age", "hours-per-week"], "bin_size": 6}),
    ("z_standardization", {"list_of_cols": ["age", "fnlwgt"]}),
    ("IQR_standardization", {"list_of_cols": ["hours-per-week"]}),
    ("normalization", {"list_of_cols": ["fnlwgt", "hours-per-week"], "output_mode": "append"}),
    ("imputation_MMM", {"list_of_cols": ["age", "workclass"], "method_type": "median"}),
    ("cat_to_num_unsupervised", {"list_of_cols": ["workclass", "education"], "method_type": "label_encoding"}),
    ("cat_to_num_supervised", {"list_of_cols": ["workclass"], "label_col": "income", "event_label": ">50K",
                               "output_mode": "append"}),
    ("outlier_categories", {"list_of_cols": ["education"], "coverage": 0.8, "max_category": 4}),
    ("boxcox_transformation", {"list_of_cols": ["hours-per-week", "fnlwgt"]}),
    ("feature_transformation", {"list_of_cols": ["hours-per-week"], "method_type": "sqrt",
                                "output_mode": "append"}),
)
EXPRESSIONS = ("log(fnlwgt) + age / 10", "(hours-per-week > 40) & (capital-gain > 0)")


def phase_transformers_direct(torch, table, df, tmp: str) -> dict:
    """Phase 10a on phase 3's Table: configs_full's six transformer steps
    chained, then the scalers, boxcox, expressions and the state contract
    of the 10 servable families; checks against float64."""
    import pandas as pd

    from anovos_tpu_torch.data_transformer import transformers as tr

    walls, launches = {}, {}
    out = {"rows": table.nrows, "walls_s": walls, "launches_by_step": launches}
    num_cols = table.attribute_type_segregation()[0]
    steps, t = {}, table
    for group in FULL_CONFIG["transformers"].values():
        for fn, kw in group.items():
            kw = dict(kw)
            if fn in ("outlier_categories", "cat_to_num_supervised", "IQR_standardization", "PCA_latentFeatures"):
                kw["model_path"] = os.path.join(tmp, "chain")  # its fitted state, for the checks
            inp = t
            t = timed_launches(torch, walls, launches, fn, lambda: getattr(tr, fn)(inp, **kw))
            steps[fn] = t
    check(on_card(steps.values()), "a transformer step left the card")
    z = timed_launches(torch, walls, launches, "z_standardization",
                       lambda: tr.z_standardization(table, num_cols, model_path=os.path.join(tmp, "z")))
    mm_ = timed_launches(torch, walls, launches, "normalization",
                         lambda: tr.normalization(table, num_cols, model_path=os.path.join(tmp, "mm")))
    bx = timed_launches(torch, walls, launches, "boxcox_transformation",
                        lambda: tr.boxcox_transformation(table, num_cols, output_mode="append"))
    ex = timed_launches(torch, walls, launches, "expression_parser",
                        lambda: tr.expression_parser(table, list(EXPRESSIONS)))
    check(on_card([z, mm_, bx, ex]), "a transformer left the card")
    states = {}
    for i, (fam, cfg) in enumerate(STATE_CASES):
        def fit_state_apply():
            import json as _json

            state = _json.loads(_json.dumps(tr.fitted_state(table, fam, cfg)))
            return state, tr.from_state(state).apply(table)

        states[fam] = timed_launches(torch, walls, launches, f"state_{fam}", fit_state_apply)
    out["seconds"] = sum(walls.values())
    print("transformers: walls " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()), flush=True)

    # the checks (float64 numpy/pandas; not timed as steps)
    t0 = time.perf_counter()
    for fam, cfg in STATE_CASES:
        kw = dict(cfg)
        if tr._STATE_MODEL_FMT.get(fam):
            kw["model_path"] = os.path.join(tmp, "batch_" + fam)
        check(tables_equal(torch, states[fam][1], getattr(tr, fam)(table, **kw)),
              f"from_state apply of {fam} differs from its batch apply")
    out.update(check_chain(df, steps, tmp))
    for name, model, fields in (("z_standardization", "z", ("mean", "stddev")),
                                ("normalization", "mm", ("min", "max"))):
        m = pd.read_parquet(os.path.join(tmp, model, name, "part-00000.parquet")).set_index("attribute")
        for c in num_cols:
            v = df[c].dropna().to_numpy(np.float64).astype(np.float32).astype(np.float64)
            if name == "z_standardization":
                mean, sd = v.mean(), v.std(ddof=1)
                check(abs(m.loc[c, "mean"] - mean) <= 1e-4 + 1e-5 * abs(mean)
                      and abs(m.loc[c, "stddev"] - sd) <= 1e-4 + 1e-4 * sd, f"z parameters of {c}")
            else:
                check(m.loc[c, "min"] == v.min() and m.loc[c, "max"] == v.max(), f"min/max of {c}")
    lam_got = np.array(states["boxcox_transformation"][0]["model"]["tables"]["boxcox_lambda"]["lambda"])
    bc_cols = STATE_CASES[8][1]["list_of_cols"]
    from anovos_tpu_torch.data_transformer.transformers import _boxcox_fit_lambdas

    Xb, Mb = table.numeric_block(num_cols)
    lam_all = _boxcox_fit_lambdas(Xb, Mb, len(num_cols))
    check(list(lam_all[[num_cols.index(c) for c in bc_cols]]) == list(lam_got), "boxcox λ of the state")
    lam_ref, margin = boxcox_reference(torch, table, num_cols)
    decided = margin > 1e-5
    bad = {c: (lam_all[j], lam_ref[j]) for j, c in enumerate(num_cols) if decided[j] and lam_all[j] != lam_ref[j]}
    check(not bad, f"boxcox λ differs from the float64 KS argmin: {bad}")
    out["boxcox_lambdas"] = dict(zip(num_cols, lam_all.tolist()))
    out["boxcox_decided"] = int(decided.sum())
    for j, c in enumerate(num_cols):
        col = bx.columns[c + "_bxcx"]
        x = df[c].to_numpy(np.float64).astype(np.float32)
        with np.errstate(all="ignore"):
            lam = np.float32(lam_all[j])
            ref = np.log(x) if lam == 0 else np.sign(x) * np.abs(x) ** lam
        valid = np.isfinite(ref)
        check(np.array_equal(col.mask.cpu().numpy(), valid), f"boxcox nulls of {c}")
        got = col.data.cpu().numpy()[valid].astype(np.float64)
        check(np.allclose(got, ref[valid].astype(np.float64), rtol=2e-6, atol=0), f"boxcox values of {c}")
    f = df["fnlwgt"].to_numpy(np.float64).astype(np.float32).astype(np.float64)
    a = df["age"].to_numpy(np.float64).astype(np.float32).astype(np.float64)
    e0 = np.log(f) + a / 10
    got0 = ex.columns[EXPRESSIONS[0]]
    v0 = ~np.isnan(e0)
    check(np.array_equal(got0.mask.cpu().numpy(), v0)
          and np.allclose(got0.data.cpu().numpy()[v0], e0[v0], rtol=1e-6, atol=0), "expression 1")
    e1 = ((df["hours-per-week"] > 40) & (df["capital-gain"] > 0)).to_numpy(np.float32)
    check(np.array_equal(ex.columns[EXPRESSIONS[1]].data.cpu().numpy(), e1), "expression 2")
    out["checks_s"] = time.perf_counter() - t0
    print(f"transformers: configs_full's six steps, the scalers, boxcox, 2 expressions and 10 served "
          f"families checked ({out['checks_s']:.1f} s): sqrt within {out['sqrt_max_ulps']:.0f} ulp; keep sets "
          f"{out['keep_sets_checked']} equal to pandas; {out['rates_checked']} rates equal to a pandas groupby "
          f"mean ({out['rates_near_tie']} near a tie); IQR exact, zero-IQR {out['iqr_zero_skipped']}; PCA k "
          f"{out['pca_k']} of {out['pca_cols']}, |cos| ≥ {out['pca_min_cos']:.7f}, within "
          f"{out['pca_min_span_cos']:.7f} of the float64 span within 1% of each eigenvalue (clusters "
          f"{out['pca_cluster_sizes']}), projections within "
          f"{out['pca_proj_rel_err']:.2e} ({out['pca_proj_vs_float64_components']:.2e} on float64's "
          f"components); boxcox λ {out['boxcox_lambdas']} ({out['boxcox_decided']} decided "
          f"by more than 1e-5); every from_state apply equal to its batch apply", flush=True)
    return out


class Recorder:
    """While in its ``with`` block, ``module.attr`` is wrapped so that the
    first argument of every call (or the instance a class builds) is
    kept in ``seen``."""

    def __init__(self, module, attr: str, instances: bool = False):
        self.module, self.attr, self.instances, self.seen = module, attr, instances, []

    def __enter__(self):
        self.saved = getattr(self.module, self.attr)
        saved, seen = self.saved, self.seen
        if self.instances:
            class Recorded(saved):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    seen.append(self)
            setattr(self.module, self.attr, Recorded)
        else:
            def call(*a, **kw):
                seen.append(a[0])
                return saved(*a, **kw)
            setattr(self.module, self.attr, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.saved)


def adam_parity(torch, ae, X) -> dict:
    """Three Adam steps on the card and on the CPU from the same fresh
    parameters on the same batches: losses within 1e-5 relative; every
    parameter within 1e-5·(1 + |p|) but the dense biases a BatchNorm
    removes (gradient 0 in exact arithmetic: within 3·lr of the start on
    both) and the running means (0.01 of those biases' gap a step)."""
    from anovos_tpu_torch.models.autoencoder import AutoEncoder

    dev = AutoEncoder(ae.n_inputs, ae.n_bottleneck).init_params(X.device)
    host = AutoEncoder(ae.n_inputs, ae.n_bottleneck).net_from_state(
        {k: v.cpu() for k, v in dev.state_dict().items()})
    start = {k: v.cpu().clone() for k, v in dev.state_dict().items()}
    batches = [X[i * AE_BATCH:(i + 1) * AE_BATCH] for i in range(3)]
    ld = [float(x) for x in AutoEncoder.train_steps(dev, torch.optim.Adam(dev.parameters(), lr=1e-3), batches)]
    lh = [float(x) for x in AutoEncoder.train_steps(host, torch.optim.Adam(host.parameters(), lr=1e-3),
                                                    [b.cpu() for b in batches])]
    check(np.allclose(ld, lh, rtol=1e-5, atol=0), f"Adam losses card {ld} vs CPU {lh}")
    worst = 0.0
    for k, v in dev.state_dict().items():
        a, b = v.cpu().numpy().astype(np.float64), host.state_dict()[k].numpy().astype(np.float64)
        if k.startswith("dense.") and k.endswith(".bias") and not k.startswith("dense.out"):
            s = start[k].numpy()
            check(np.abs(a - s).max() <= 3e-3 * (1 + 1e-6) and np.abs(b - s).max() <= 3e-3 * (1 + 1e-6), k)
            continue
        if k.endswith(".mean"):
            check(np.abs(a - b).max() <= 1e-5 * (1 + np.abs(b).max()) + 3e-4, k)
            continue
        err = float((np.abs(a - b) / (1 + np.abs(b))).max())
        worst = max(worst, err)
        check(err <= 1e-5, f"{k} after 3 Adam steps: card vs CPU {err}")
    return {"adam_losses": ld, "adam_param_rel_err": worst}


def phase_autoencoder(torch, table, tmp: str) -> dict:
    """Phase 10b: autoencoder_latentFeatures at n = 9, k = 4 on phase 3's
    numeric columns, configs_segmentation_unsupervised's sample and batch,
    AE_EPOCHS epochs."""
    from anovos_tpu_torch.data_transformer import latent_features as lf
    from anovos_tpu_torch.models.autoencoder import AutoEncoder

    walls, launches = {}, {}
    out = {"walls_s": walls, "launches_by_step": launches, "epochs": AE_EPOCHS}
    num_cols = table.attribute_type_segregation()[0]
    mp = os.path.join(tmp, "ae")
    with Recorder(lf, "AutoEncoder", instances=True) as rec:
        lat = timed_launches(torch, walls, launches, "autoencoder_latentFeatures",
                             lambda: lf.autoencoder_latentFeatures(
                                 table, num_cols, reduction_params=0.5, sample_size=AE_SAMPLE,
                                 epochs=AE_EPOCHS, batch_size=AE_BATCH, model_path=mp, output_mode="append"))
    ae = rec.seen[0]
    out["epoch_s"] = walls["autoencoder_latentFeatures"] / AE_EPOCHS
    out["history"] = ae.history
    print(f"autoencoder: {AE_EPOCHS} epochs of {int(AE_SAMPLE * 0.8) // AE_BATCH} steps in "
          f"{walls['autoencoder_latentFeatures']:.2f} s; validation MSE by epoch "
          f"{[round(h['val_mse'], 5) for h in ae.history]}", flush=True)
    t0 = time.perf_counter()
    k = ae.n_bottleneck
    check((ae.n_inputs, k) == (9, 4), f"autoencoder width {ae.n_inputs} → {k}")
    val = [h["val_mse"] for h in ae.history]
    check(bool(np.isfinite(val).all()) and val[-1] < val[0] and val[-1] < 1.0,
          f"validation MSE {val[0]} → {val[-1]} (mean predictor 1.0)")
    latents = [lat.columns[f"latent_{i}"].data for i in range(k)]
    check(on_card([lat]), "the latents left the card")
    X, _, _ = lf._prep_block(table, num_cols, True, True)
    ae2, params = AutoEncoder.load(mp, X.device)
    Z = ae2.latent(params, X)
    check(all(torch.equal(Z[:, i], latents[i]) for i in range(k)), "model.npz round trip changed the latents")
    rows = 200_000
    host_net = ae2.net_from_state({kk: v.cpu() for kk, v in params.state_dict().items()})
    Zh = ae2.latent(host_net, X[:rows].cpu()).numpy().astype(np.float64)
    Zd = Z[:rows].cpu().numpy().astype(np.float64)
    out["latent_card_vs_cpu"] = float((np.abs(Zd - Zh) / (1 + np.abs(Zh))).max())
    check(out["latent_card_vs_cpu"] <= 1e-5, f"latents on the card vs the CPU: {out['latent_card_vs_cpu']}")
    out.update(adam_parity(torch, ae, X))
    out["checks_s"] = time.perf_counter() - t0
    print(f"autoencoder: validation MSE {val[0]:.5f} → {val[-1]:.5f}; model.npz round trip bit-equal; card "
          f"latents within {out['latent_card_vs_cpu']:.2e} of a CPU forward ({rows} rows); 3 Adam steps' "
          f"losses {out['adam_losses']} equal the CPU's to 1e-5, parameters within "
          f"{out['adam_param_rel_err']:.2e} ({out['checks_s']:.1f} s of checks)", flush=True)
    return out


def impute_frame(df):
    """Phase 10c's table: IMPUTE_ROWS of phase 3's numeric columns and two
    columns linear in age and hours-per-week (correlation about 0.9, so a
    model beats the mean without making the regression ill-conditioned),
    with 5% nulls in age, fnlwgt and hours-per-week."""
    num = df.select_dtypes("number").iloc[:IMPUTE_ROWS].reset_index(drop=True).copy()
    g = np.random.default_rng(10)
    n = len(num)
    num["age_x"] = 0.5 * num["age"].fillna(40.0) + g.normal(0, 5.0, n)
    num["hours_x"] = 2.0 * num["hours-per-week"] + g.normal(0, 20.0, n)
    for c in IMPUTE_COLS:
        num.loc[g.random(n) < 0.05, c] = np.nan
    return num


def knn_reference(Xq, Mq, Xs, Ms, j: int, K: int = 5):
    """Feature j of each query row by float64 nan-euclidean K-NN over the
    fit sample (ties toward the lower fit row), and whether the port's f32
    distances must pick the same donors: the expanded distance of a donor
    is off by up to 8 ulps of Σ x² + y² over the features both observe
    (centred on the fit set's mean), so the pick is decided where the K
    nearest, each at its distance plus that error, stay nearer than every
    other donor at its distance less its own."""
    k = Xq.shape[1]
    mu = np.array([Xs[Ms[:, c], c].mean() for c in range(k)])
    out, clear = np.zeros(len(Xq)), np.zeros(len(Xq), bool)
    xs = np.where(Ms, Xs - mu, 0.0)
    eps = float(np.finfo(np.float32).eps)
    for i in range(len(Xq)):
        both = Mq[i][None, :] & Ms
        xq = np.where(Mq[i], Xq[i] - mu, 0.0)
        scale = k / np.maximum(both.sum(1), 1)
        d2 = np.where(both, (xq[None, :] - xs) ** 2, 0.0).sum(1) * scale
        d2[(both.sum(1) == 0) | ~Ms[:, j]] = np.inf
        err = 8 * eps * np.where(both, xq[None, :] ** 2 + xs ** 2, 0.0).sum(1) * scale
        order = np.lexsort((np.arange(len(d2)), d2))
        top, rest = order[:K], order[K:]
        rest = rest[np.isfinite(d2[rest])]
        out[i] = Xs[top, j].mean()
        clear[i] = not len(rest) or (d2[top] + err[top]).max() < (d2[rest] - err[rest]).min()
    return out, clear


def ridge_reference(torch, X, M, device, iters: int = 10):
    """The round-robin regression in float64 (on ``device``): each sweep,
    column j by least squares (``torch.linalg.lstsq``) on the other
    columns as filled and an intercept, over the rows that observe it, its
    missing cells refreshed; then the apply, one pass of the fitted
    columns in order from the mean fill.  Returns (coefs (k, k + 1), the
    applied matrix) on the host."""
    X = torch.as_tensor(X, dtype=torch.float64, device=device)
    M = torch.as_tensor(M, device=device)
    n, k = X.shape
    means = torch.where(M, X, 0.0).sum(0) / M.sum(0)
    ones = torch.ones((n, 1), dtype=torch.float64, device=device)
    coefs = torch.zeros((k, k + 1), dtype=torch.float64, device=device)

    def design(Xf, j):
        return torch.cat([Xf[:, [c for c in range(k) if c != j]], ones], 1)

    Xf = torch.where(M, X, means[None, :])
    for _ in range(iters):
        for j in range(k):
            A = design(Xf, j)
            rows = M[:, j]
            beta = torch.linalg.lstsq(A[rows], X[rows, j:j + 1]).solution[:, 0]
            Xf[:, j] = torch.where(M[:, j], X[:, j], A @ beta)
            coefs[j, [c for c in range(k) if c != j]] = beta[:-1]
            coefs[j, k] = beta[-1]
    Xa = torch.where(M, X, means[None, :])
    for j in range(k):
        beta = torch.cat([coefs[j, [c for c in range(k) if c != j]], coefs[j, k:]])
        Xa[:, j] = torch.where(M[:, j], X[:, j], design(Xa, j) @ beta)
    return coefs.cpu().numpy(), Xa.cpu().numpy()


def phase_imputers(torch, df, tmp: str) -> dict:
    """Phase 10c on an IMPUTE_ROWS table: KNN, regression, MF and auto,
    each timed, checked against float64 numpy and the CPU port."""
    from anovos_tpu_torch.data_transformer import imputers as imp
    from anovos_tpu_torch.ops.als import als_impute
    from anovos_tpu_torch.ops.reductions import masked_moments
    from anovos_tpu_torch.shared.table import Table

    frame = impute_frame(df)
    t = Table.from_pandas(frame)
    torch.cuda.synchronize()
    walls, launches = {}, {}
    out = {"rows": t.nrows, "walls_s": walls, "launches_by_step": launches}
    knn = timed_launches(torch, walls, launches, "KNN", lambda: imp.imputation_sklearn(t, method_type="KNN"))
    reg = timed_launches(torch, walls, launches, "regression",
                         lambda: imp.imputation_sklearn(t, method_type="regression",
                                                        model_path=os.path.join(tmp, "ridge")))
    mf = timed_launches(torch, walls, launches, "MF", lambda: imp.imputation_matrixFactorization(t))
    auto = timed_launches(torch, walls, launches, "auto", lambda: imp.auto_imputation(t, print_impact=False))
    check(on_card([knn, reg, mf, auto]), "an imputer left the card")
    print("imputers: walls " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()), flush=True)

    t0 = time.perf_counter()
    cols = list(frame.columns)
    X = frame.to_numpy(np.float64).astype(np.float32).astype(np.float64)
    M = ~np.isnan(X)
    X = np.where(M, X, 0.0)
    tgt = [cols.index(c) for c in IMPUTE_COLS]
    for o in (knn, reg, mf, auto):
        for c in IMPUTE_COLS:
            check(bool(o.columns[c].mask.all()) and bool(torch.isfinite(o.columns[c].data).all()), f"{c} imputed")
    # KNN: seeded query rows against float64 over the same fit sample,
    # where f32 distances decide the same donors (knn_reference)
    pick = np.random.default_rng(42).choice(t.nrows, size=10000, replace=False)
    g = np.random.default_rng(11)
    checked = same = queried = 0
    worst = 0.0
    for j in tgt:
        rows = g.choice(np.flatnonzero(~M[:, j]), KNN_QUERIES // len(tgt), replace=False)
        ref, clear = knn_reference(X[rows], M[rows], X[pick], M[pick], j)
        got = knn.columns[cols[j]].data.cpu().numpy()[rows].astype(np.float64)
        err = np.abs(got - ref) / (1 + np.abs(ref))
        queried += len(rows)
        same += int((err <= 1e-5).sum())
        checked += int(clear.sum())
        if clear.any():
            worst = max(worst, float(err[clear].max()))
    check(worst <= 1e-5 and checked >= KNN_QUERIES // 6,
          f"KNN off float64 by {worst} where its donors are decided ({checked} rows)")
    out.update(knn_queried=queried, knn_decided=checked, knn_equal_float64=same, knn_rel_err=worst)
    # regression: coefficients and imputed cells against float64 lstsq
    blob = np.load(os.path.join(tmp, "ridge", "imputation_sklearn_regression.npz"))
    coefs64, Xf64 = ridge_reference(torch, X, M, t.device)
    sd = np.array([X[M[:, j], j].std() for j in range(len(cols))])
    scaled = np.abs(blob["coefs"][:, :-1] - coefs64[:, :-1]) * sd[None, :] / sd[:, None]
    out["ridge_coef_err_in_sd"] = float(scaled.max())
    check(out["ridge_coef_err_in_sd"] <= 1e-3, f"ridge coefficients off float64 by {scaled.max()} σ")
    worst = 0.0
    for j in tgt:
        miss = ~M[:, j]
        got = reg.columns[cols[j]].data.cpu().numpy()[miss].astype(np.float64)
        worst = max(worst, float(np.abs(got - Xf64[miss, j]).max() / sd[j]))
    out["ridge_pred_err_in_sd"] = worst
    check(worst <= 1e-3, f"ridge imputations off float64 by {worst} σ")
    # MF: the completion of the observed cells
    Xt, Mt = t.numeric_block(cols)
    mom = masked_moments(Xt, Mt)
    std = torch.where(mom["stddev"] > 0, mom["stddev"], 1.0)
    Zt = torch.where(Mt, (Xt - mom["mean"]) / std, 0.0)
    C = als_impute(Zt, Mt, rank=min(10, max(2, len(cols) - 1)), iters=20, reg=0.01)
    out["mf_observed_rmse_sd"] = float(torch.sqrt(((C - Zt)[Mt] ** 2).mean()))
    check(np.isfinite(out["mf_observed_rmse_sd"]) and out["mf_observed_rmse_sd"] <= MF_RMSE_BOUND,
          f"MF observed-cell RMSE {out['mf_observed_rmse_sd']} σ")
    # auto: its output is its choice's on the whole table; the card's choice
    # against the CPU port's on the same holdout of the first AUTO_REF_ROWS rows
    full = imp.auto_imputation_scores(t, IMPUTE_COLS)
    chosen = min(full, key=full.get)
    direct = imp._candidates(IMPUTE_COLS)[chosen](t)
    check(tables_equal(torch, auto, direct), f"auto_imputation's output is not {chosen}'s")
    head = frame.iloc[:AUTO_REF_ROWS]
    card = imp.auto_imputation_scores(Table.from_pandas(head), IMPUTE_COLS)
    t_cpu = Table.from_pandas(head, device="cpu")
    t1 = time.perf_counter()
    host = imp.auto_imputation_scores(t_cpu, IMPUTE_COLS)
    out["auto_cpu_s"] = time.perf_counter() - t1
    best, best_cpu = min(card, key=card.get), min(host, key=host.get)
    srt = sorted(host.values())
    out.update(auto_scores_full=full, auto_choice=chosen, auto_ref_rows=len(head), auto_scores_card=card,
               auto_scores_cpu=host)
    if srt[1] - srt[0] > 1e-4 * srt[0]:
        check(best == best_cpu, f"auto_imputation chose {best} on the card, {best_cpu} on the CPU")
    else:
        check(card[best_cpu] - card[best] <= 1e-4 * card[best], f"auto near tie: {card} vs {host}")
    out["checks_s"] = time.perf_counter() - t0
    print(f"imputers: KNN within {out['knn_rel_err']:.2e} of float64 on the {checked} of {queried} query "
          f"rows whose donors f32 distances decide ({same} of {queried} equal float64's); ridge coefficients within {out['ridge_coef_err_in_sd']:.2e} σ, "
          f"imputations {out['ridge_pred_err_in_sd']:.2e} σ of float64; MF observed-cell RMSE "
          f"{out['mf_observed_rmse_sd']:.4f} σ; auto chose {chosen} on {t.nrows} rows, and on the first "
          f"{len(head)} {best} on the card and {best_cpu} on the CPU (CPU scores in {out['auto_cpu_s']:.1f} s) "
          f"({out['checks_s']:.1f} s of checks)", flush=True)
    return out


def full_inputs(seed: int, root: str, rows: int):
    """10d's input under ``root``: ``rows`` synthesized rows as parquet
    (the drift source too) and four CSV slices of its numeric columns for
    the stability index.  Returns (the frame, main dir, the four dirs)."""
    from examples._data import synthesize

    full = synthesize(rows, seed=seed + 10)
    main_dir = os.path.join(root, "full_income")
    os.makedirs(main_dir)
    full.to_parquet(os.path.join(main_dir, "part-00000.parquet"), index=False)
    num = full.select_dtypes("number").drop(columns=["empty", "logfnl"])
    si = []
    for i in range(4):
        d = os.path.join(root, "full_si", str(i))
        os.makedirs(d)
        num.iloc[i * rows // 4:(i + 1) * rows // 4].to_csv(os.path.join(d, "part-00000.csv"), index=False)
        si.append(d)
    return full, main_dir, si


def phase_full_runner(torch, seed: int, root: str) -> dict:
    """Phase 10d: workflow.main on FULL_CONFIG (configs_full.yaml) in the
    runner's default executor mode, its input (``full_inputs``, FULL_ROWS
    rows) and working directory under ``root``, which the caller keeps for
    phase 15."""
    import pandas as pd

    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.data_transformer import transformers as tr

    out = {"rows": FULL_ROWS}
    full, main_dir, si = full_inputs(seed, root, FULL_ROWS)
    out.update(main_dir=main_dir, si_dirs=si)
    run_dir = os.path.join(root, "full_run")
    walls, launches = {}, {}
    out.update(walls_s=walls, launches_by_step=launches)
    with Recorder(tr, "feature_transformation") as rec, executor(None):
        run = run_measured(torch, full_config(main_dir, si), run_dir)
    walls["workflow.main"], launches["workflow.main"] = run.pop("wall_s"), run.pop("launches")
    out.update(run)
    out["wall_s"] = walls["workflow.main"]
    print("full runner: block walls " + ", ".join(f"{k} {v:.3f} s" for k, v in out["block_times_s"].items())
          + f"; workflow.main {out['wall_s']:.3f} s", flush=True)
    print_schedule("full runner", run)
    check(workflow.degraded_sections() == {}, f"runner blocks failed: {workflow.degraded_sections()}")
    tdir = os.path.join(run_dir, "intermediate_data", "data_transformer", "transformers")
    for group in FULL_CONFIG["transformers"].values():
        for fn in group:
            check(os.path.isdir(os.path.join(tdir, fn)) and os.listdir(os.path.join(tdir, fn)),
                  f"no intermediate dataset of {fn}")
    check(len(rec.seen) == 1, "the runner's transformers block ran feature_transformation once")
    t = rec.seen[0]
    for group in FULL_CONFIG["transformers"].values():
        for fn, kw in group.items():
            t = getattr(tr, fn)(t, **kw)
    final = pd.read_parquet(os.path.join(run_dir, "output", "final_dataset"))
    try:
        pd.testing.assert_frame_equal(final, t.to_pandas(), check_dtype=False)
    except AssertionError as e:
        fail(f"full runner: final_dataset differs from the direct chain: {e}")
    out["final_columns"] = list(final.columns)
    print(f"full runner: configs_full on {FULL_ROWS} rows, the six transformer datasets written, the final "
          f"dataset ({len(final)} rows, {list(final.columns)}) equal to the direct chain, no block failed",
          flush=True)
    return out


def phase_transformers(torch, seed: int, table, df, root: str) -> dict:
    """Phase 10 (10a-d): the counts are set to 0 before it, and its path's
    launches are those of its timed steps; then B1 and B2 against their
    plain versions on every input the phase gave them on the card.  10d's
    input and working directory go under ``root`` (phase 15 reads them)."""
    from anovos_tpu_torch.ops import kernels

    out = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        with KernelInputs(torch) as given:
            out["direct"] = phase_transformers_direct(torch, table, df, tmp)
            out["autoencoder"] = phase_autoencoder(torch, table, tmp)
            out["imputers"] = phase_imputers(torch, df, tmp)
            out["runner"] = phase_full_runner(torch, seed, root)
    # the path's launches: those of the timed steps (each step's own, read
    # before its checks ran)
    out["launches"] = {name: sum(step[name] for part in out.values() for step in part["launches_by_step"].values())
                       for name in kernels.LAUNCHES}
    print(f"transformers: kernel launches {out['launches']}", flush=True)
    for name in PATH_KERNELS["transformers"]:
        check(out["launches"][name] > 0, f"kernel {name} was not launched on the transformers path")
    # after the path (not counted): B1 and B2 on every input the phase gave
    # them on the card, against their plain versions; timed at each new
    # shape (the CPU port's calls in 10c's check ran the plain versions)
    out["kernels"], out["kernel_calls_checked"] = given_kernel_rows(torch, given, "transformers", {(9, table.nrows)})
    out["phase_s"] = time.perf_counter() - t0
    print(f"transformers: phase 10 in {out['phase_s']:.1f} s, B1 checked on "
          f"{out['kernel_calls_checked']['masked_moments']} calls and B2 on "
          f"{out['kernel_calls_checked']['binned_histograms']}", flush=True)
    del given
    return out


def given_kernel_rows(torch, given, path: str, timed_shapes: set):
    """B1 and B2 on every input a path gave them on the card (``given``, a
    :class:`KernelInputs`), each against its plain version; the first call
    at each shape not in ``timed_shapes`` also timed (``b1_row``/``b2_row``).
    Returns (the timed rows by kernel, the calls checked by kernel)."""
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain

    b1 = [a for a in given.seen["masked_moments"] if a[0].is_cuda]
    b2 = [a for a in given.seen["binned_histograms"] if a[0].is_cuda]
    rows, timed_shapes = {"masked_moments": [], "binned_histograms": []}, set(timed_shapes)
    for i, (Xc, Mc) in enumerate(b1):
        if tuple(Xc.shape) in timed_shapes:
            acc = masked_moments_cols(Xc, Mc)
            moments_errors(acc.cpu().numpy(), masked_moments_plain(Xc, Mc).cpu().numpy())
            continue
        timed_shapes.add(tuple(Xc.shape))
        rows["masked_moments"].append(b1_row(torch, Xc, Mc, path, f"launch {i + 1} of {len(b1)}"))
    for i, (Xc, Mc, cuts, nbins) in enumerate(b2):
        if tuple(Xc.shape) in timed_shapes:
            check(torch.equal(binned_histograms_cols(Xc, Mc, cuts, nbins),
                              binned_histograms_plain(Xc, Mc, cuts, nbins)),
                  f"binned_histograms differs from plain on the {path} path")
            continue
        timed_shapes.add(tuple(Xc.shape))
        rows["binned_histograms"].append(b2_row(torch, Xc, Mc, cuts, nbins, path, f"launch {i + 1} of {len(b2)}"))
    return rows, {"masked_moments": len(b1), "binned_histograms": len(b2)}


# ---------------------------------------------------------------------------
# phase 11: the host codec at scale and the four remaining shipped configs
# ---------------------------------------------------------------------------
def income_config(main_dir: str, join_dir: str, si_dirs) -> dict:
    """config/configs.yaml: FULL_CONFIG (configs_full.yaml) with the
    concatenate (a second read of the input) and the avro join after its
    input, and the geo analyzer switched off."""
    import copy

    full = full_config(main_dir, si_dirs)
    cfg = {}
    for key, block in full.items():
        cfg[key] = block
        if key == "input_dataset":
            cfg["concatenate_dataset"] = {"method": "name", "dataset1": {
                "read_dataset": {"file_path": main_dir, "file_type": "parquet"}, "delete_column": ["logfnl"],
                "select_column": None, "rename_column": copy.deepcopy(_INCOME_ETL["rename_column"]),
                "recast_column": copy.deepcopy(_INCOME_ETL["recast_column"])}}
            cfg["join_dataset"] = {"join_cols": "ifa", "join_type": "inner", "dataset1": {
                "read_dataset": {"file_path": join_dir, "file_type": "avro"}, "delete_column": None,
                "select_column": None, "rename_column": {"list_of_cols": "age|workclass",
                                                         "list_of_newcols": "dupl_age|dupl_workclass"},
                "recast_column": None}}
    cfg["geospatial_controller"]["geospatial_analyzer"]["auto_detection_analyzer"] = False
    return cfg


def checkin_config(template: dict, checkin_dir: str, si_dirs=()) -> dict:
    """TS_SCENARIO_CONFIG or GEO_SCENARIO_CONFIG with the input pointed at
    ``checkin_dir`` and the stability datasets at ``si_dirs``."""
    import copy

    cfg = copy.deepcopy(template)
    cfg["input_dataset"]["read_dataset"]["file_path"] = checkin_dir
    for i, d in enumerate(si_dirs):
        cfg["drift_detector"]["stability_index"][f"dataset{i + 1}"]["read_dataset"]["file_path"] = d
    return cfg


def mlflow_config(main_dir: str) -> dict:
    import copy

    cfg = copy.deepcopy(MLFLOW_CONFIG)
    cfg["input_dataset"]["read_dataset"]["file_path"] = main_dir
    return cfg


def feast_config(main_dir: str) -> dict:
    import copy

    cfg = copy.deepcopy(FEAST_CONFIG)
    cfg["input_dataset"]["read_dataset"]["file_path"] = main_dir
    return cfg


def checkin_frame(n: int, seed: int):
    """The check-in dataset's schema (users' venue check-ins): userId,
    venueId, venueCategoryId, venueCategory, latitude and longitude around
    six cities (geo_frame's layout), timezoneOffset and utcTimestamp in the
    dataset's text format ("Tue Apr 03 18:00:09 +0000 2012")."""
    import pandas as pd

    g = np.random.default_rng(seed)
    cats = np.array(["Bar", "Coffee Shop", "Gym / Fitness Center", "Office", "Subway", "Home (private)", "Café",
                     "Train Station", "Park", "Food & Drink Shop"], object)
    centers = np.array([(40.7, -74.0), (35.7, -120.0), (30.3, -97.7), (41.9, -87.6), (47.6, -100.3),
                        (33.7, -84.4)])
    pts = centers[g.integers(0, len(centers), n)] + g.normal(0, 0.3, (n, 2))
    noise = g.random(n) < 0.02
    pts[noise] = np.stack([g.uniform(25, 49, noise.sum()), g.uniform(-124, -71, noise.sum())], 1)
    venues = g.integers(0, 40_000, n)
    cat = g.integers(0, len(cats), n)
    secs = g.integers(1333238400, 1360000000, n)  # April 2012 to February 2013
    return pd.DataFrame({
        "userId": g.integers(1, 1084, n),
        "venueId": pd.Series(venues * 7919 + 0x4A000000).map("{:024x}".format).astype(str),
        "venueCategoryId": pd.Series(cats[cat]).map({c: f"4bf58dd8d48988d1{i:02d}941735"
                                                     for i, c in enumerate(cats)}).astype(str),
        "venueCategory": pd.Series(cats[cat]).astype(str),
        "latitude": pts[:, 0], "longitude": pts[:, 1],
        "timezoneOffset": g.choice([-240, -300, 540], n),
        "utcTimestamp": pd.Series(pd.to_datetime(secs, unit="s").strftime("%a %b %d %H:%M:%S +0000 %Y")).astype(str),
    })


def decoded_equal(df, decoded: dict) -> bool:
    """The codec's columns (codes + vocabulary for strings) hold ``df``'s
    values, nulls where it has nulls."""
    import pandas as pd

    if list(decoded) != list(df.columns):
        return False
    for c in df.columns:
        got, exp = decoded[c], df[c]
        if hasattr(got, "codes"):
            if not np.array_equal(got.codes < 0, exp.isna().to_numpy()):
                return False
            valid = got.codes >= 0
            if not (pd.Series(got.vocab[got.codes[valid]]) == exp[valid].reset_index(drop=True)).all():
                return False
        elif not np.array_equal(got, exp.to_numpy(), equal_nan=exp.dtype.kind == "f"):
            return False
    return True


def phase_codec(seed: int, tmp: str) -> dict:
    """11a: an avro file of CODEC_ROWS rows of the full income schema
    written and read through the codec with deflate and then snappy, read
    back equal to the frame; on its first CODEC_REF_ROWS rows the codec
    and the pure-Python record loops, timed at the same row count."""
    from examples._data import synthesize
    from anovos_tpu_torch.data_ingest import avro_io

    out = {"rows": CODEC_ROWS, "ref_rows": CODEC_REF_ROWS}
    walls = out["walls_s"] = {}
    df = synthesize(CODEC_ROWS, seed=seed + 11)
    for codec in ("deflate", "snappy"):
        path = os.path.join(tmp, f"codec_{codec}.avro")
        t0 = time.perf_counter()
        avro_io.write_avro(df, path, codec=codec)
        walls[f"write {codec}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = avro_io.read_avro(path)
        walls[f"read {codec}"] = time.perf_counter() - t0
        out[f"{codec}_bytes"] = os.path.getsize(path)
        check(decoded_equal(df, back), f"codec: the {codec} file read back differs from the frame")
        del back
    head = df.iloc[:CODEC_REF_ROWS].reset_index(drop=True)
    del df
    ref_walls = out["ref_walls_s"] = {}
    for name, write in (("codec", avro_io.write_avro), ("python", avro_io.write_avro_records)):
        path = os.path.join(tmp, f"ref_{name}.avro")
        t0 = time.perf_counter()
        write(head, path, codec="deflate")
        ref_walls[f"{name} write"] = time.perf_counter() - t0
    for name, read in (("codec", avro_io.read_avro), ("python", avro_io.read_avro_records)):
        t0 = time.perf_counter()
        back = read(os.path.join(tmp, f"ref_{name}.avro"))
        ref_walls[f"{name} read"] = time.perf_counter() - t0
        if name == "python":  # object strings: the same check on codes of them
            from anovos_tpu_torch.shared.native import dict_encode_strings

            back = {c: dict_encode_strings(v) if v.dtype == object else v for c, v in back.items()}
        check(decoded_equal(head, back), f"codec: the {name} writer's file read back differs")
    for op in ("write", "read"):
        out[f"{op}_speedup"] = ref_walls[f"python {op}"] / ref_walls[f"codec {op}"]
    print("codec: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f" at {CODEC_ROWS} rows x {len(head.columns)} columns (deflate {out['deflate_bytes']} bytes, "
          f"snappy {out['snappy_bytes']} bytes), read back equal", flush=True)
    print(f"codec: at {CODEC_REF_ROWS} rows (deflate): " + ", ".join(f"{k} {v:.3f} s" for k, v in ref_walls.items())
          + f"; the codec {out['write_speedup']:.1f}x the Python writer, {out['read_speedup']:.1f}x the reader",
          flush=True)
    return out


def income_reference(src, side):
    """configs.yaml's ingest in pandas: the input's ETL, the concatenate
    with the second read (``logfnl`` deleted, columns by the input's names),
    the inner join with the side's age and workclass renamed on ifa, dt_1
    parsed by ``pandas.to_datetime``."""
    import pandas as pd

    etl = src.drop(columns=["logfnl", "empty", "dt_2"]).rename(
        columns={"marital-status": "marital_status", "education-num": "education_num"})
    for c in ("age", "education_num"):
        etl[c] = etl[c].astype(np.float32).astype(np.float64)
    cat = pd.concat([etl, etl], ignore_index=True)
    ref = cat.merge(side.rename(columns={"age": "dupl_age", "workclass": "dupl_workclass"}), on="ifa", how="inner")
    ref["dt_1"] = pd.to_datetime(ref["dt_1"])
    return ref


def run_config(torch, cfg: dict, run_dir: str, path: str, given=None) -> dict:
    """``workflow.main(cfg)`` in ``run_dir``, its launches counted from 0."""
    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.ops import kernels

    os.makedirs(run_dir)
    cwd = os.getcwd()
    kernels.reset_launches()
    os.chdir(run_dir)
    try:
        t0 = time.perf_counter()
        workflow.main(cfg, "local")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    out = {"wall_s": wall, "launches": dict(kernels.LAUNCHES), "block_times_s": workflow.block_times(),
           "degraded": workflow.degraded_sections()}
    for name in PATH_KERNELS[path]:
        check(out["launches"][name] > 0, f"kernel {name} was not launched by {path}")
    blocks = sum(out["block_times_s"].values())
    print(f"{path}: workflow.main {wall:.3f} s, blocks {blocks:.3f} s, the rest (reads and writes) "
          f"{wall - blocks:.3f} s; " + ", ".join(f"{k} {v:.3f}" for k, v in out["block_times_s"].items())
          + f"; launches {out['launches']}", flush=True)
    return out


def check_files(rdir: str, names, what: str) -> int:
    missing = [n for n in names if not os.path.exists(os.path.join(rdir, n))]
    check(not missing, f"{what}: files not written: {missing}")
    return len(names)


def phase_configs_yaml(torch, seed: int, tmp: str) -> dict:
    """11b: configs.yaml through ``workflow.main`` on SCENARIO_ROWS rows of
    the full income schema as parquet, concatenated with a second read and
    joined with an avro side of one row per distinct ifa, so every row is
    profiled; then B1 and B2 on the inputs the runner gave them."""
    import pandas as pd

    from examples._data import synthesize
    from anovos_tpu_torch.data_ingest.data_ingest import write_dataset
    from anovos_tpu_torch.shared.table import Table

    t0 = time.perf_counter()
    src = synthesize(SCENARIO_ROWS, seed=seed + 12)
    main_dir, join_dir = os.path.join(tmp, "scenario_income"), os.path.join(tmp, "scenario_join")
    os.makedirs(main_dir)
    src.to_parquet(os.path.join(main_dir, "part-00000.parquet"), index=False)
    side = src[["ifa", "age", "workclass"]].drop_duplicates("ifa").reset_index(drop=True)
    write_dataset(Table.from_pandas(side), join_dir, "avro")
    num = src.select_dtypes("number").drop(columns=["empty", "logfnl"])
    si = []
    for i in range(4):
        d = os.path.join(tmp, "scenario_si", str(i))
        os.makedirs(d)
        num.iloc[i * SCENARIO_ROWS // 4:(i + 1) * SCENARIO_ROWS // 4].to_csv(os.path.join(d, "part-00000.csv"),
                                                                             index=False)
        si.append(d)
    del num
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    run_dir = os.path.join(tmp, "scenario_run")
    with KernelInputs(torch) as given:
        out = run_config(torch, income_config(main_dir, join_dir, si), run_dir, "configs_yaml")
    out.update(rows=SCENARIO_ROWS, side_rows=len(side), setup_s=setup_s)
    # the config drifts every column of the joined table against the
    # unjoined source: both packages degrade drift_statistics (ROADMAP Queue C)
    check(list(out["degraded"]) == ["drift_detector/drift_statistics"]
          and "dupl_age" in out["degraded"]["drift_detector/drift_statistics"],
          f"configs.yaml: degraded sections {out['degraded']}")
    out["kernels"], out["kernel_calls_checked"] = given_kernel_rows(torch, given, "configs_yaml", set())
    del given

    t0 = time.perf_counter()
    ref = income_reference(src, side)
    del src
    check(len(ref) == 2 * SCENARIO_ROWS, "configs.yaml: the pandas join")
    joined = pd.read_csv(os.path.join(run_dir, "intermediate_data", "data_ingest", "join_dataset",
                                      "part-00000.csv"))
    keys = ["ifa", "age", "workclass", "dupl_age", "dupl_workclass"]
    got = joined[keys].sort_values(keys).reset_index(drop=True)
    exp = ref[keys].sort_values(keys).reset_index(drop=True)
    try:
        pd.testing.assert_frame_equal(got, exp, check_dtype=False)
    except AssertionError as e:
        fail(f"configs.yaml: the joined dataset differs from the pandas concat and join: {e}")
    del joined, got, exp
    rdir = os.path.join(run_dir, "report_stats")
    check_runner_stats(ref, rdir)
    final = pd.read_parquet(os.path.join(run_dir, "output", "final_dataset"))
    # the duplicate check drops the concatenate's second copy of every row
    check(len(final) == SCENARIO_ROWS and bool(final["ifa"].is_unique), f"configs.yaml: final rows {len(final)}")
    lat = [c for c in final.columns if c.startswith("latent_")]
    check(lat and bool(np.isfinite(final[lat].to_numpy(np.float64)).all()), "configs.yaml: PCA latents")
    tdir = os.path.join(run_dir, "intermediate_data", "data_transformer", "transformers")
    out["files_checked"] = check_files(tdir, [fn for g in FULL_CONFIG["transformers"].values() for fn in g],
                                       "configs.yaml transformers")
    out["files_checked"] += check_files(rdir, ["correlation_matrix.csv", "IV_calculation.csv",
                                               "variable_clustering.csv", "stability_index.csv",
                                               "ts_cols_stats.csv", "ml_anovos_report.html"], "configs.yaml")
    out["checks_s"] = time.perf_counter() - t0
    print(f"configs_yaml: {SCENARIO_ROWS} rows concatenated to {2 * SCENARIO_ROWS}, joined with {len(side)} avro "
          f"rows; the joined dataset equal to pandas, the stats CSVs in phase 3's bands, {len(final)} final rows "
          f"with {len(lat)} latents ({out['checks_s']:.1f} s of checks)", flush=True)
    return out


def checkin_reference(df, converted: bool):
    """The check-in frame as the runner profiles it: utcTimestamp parsed
    when the time-series config converted it."""
    import pandas as pd

    ref = df.copy()
    if converted:
        ref["utcTimestamp"] = pd.to_datetime(ref["utcTimestamp"], format="%a %b %d %H:%M:%S +0000 %Y")
    return ref


def phase_checkin_configs(torch, seed: int, tmp: str) -> dict:
    """11c: configs_time_series, configs_geospatial, configs_mlflow and
    configs_feast through ``workflow.main`` on CHECKIN_ROWS rows each (the
    check-in schema as CSV for the first two, the income schema as parquet
    for mlflow, which runs with ``mlflow`` unimportable, and for feast)."""
    import pandas as pd

    from examples._data import synthesize

    out = {}
    chk = checkin_frame(CHECKIN_ROWS, seed + 13)
    cdir = os.path.join(tmp, "checkin")
    os.makedirs(cdir)
    chk.to_csv(os.path.join(cdir, "part-00000.csv"), index=False)
    income = synthesize(CHECKIN_ROWS, seed=seed + 14)
    idir = os.path.join(tmp, "mlflow_income")
    os.makedirs(idir)
    income.to_parquet(os.path.join(idir, "part-00000.parquet"), index=False)
    num = income.select_dtypes("number").drop(columns=["empty", "logfnl"])
    si = []
    for i in range(3):
        d = os.path.join(tmp, "checkin_si", str(i))
        os.makedirs(d)
        num.iloc[i * CHECKIN_ROWS // 3:(i + 1) * CHECKIN_ROWS // 3].to_csv(os.path.join(d, "part-00000.csv"),
                                                                           index=False)
        si.append(d)
    del num
    runs = (("configs_time_series", checkin_config(TS_SCENARIO_CONFIG, cdir, si)),
            ("configs_geospatial", checkin_config(GEO_SCENARIO_CONFIG, cdir)),
            ("configs_mlflow", mlflow_config(idir)),
            ("configs_feast", feast_config(idir)))
    saved = sys.modules.get("mlflow")
    sys.modules["mlflow"] = None  # `import mlflow` raises ImportError
    try:
        given = {}
        for path, cfg in runs:
            with KernelInputs(torch) as given[path]:
                out[path] = run_config(torch, cfg, os.path.join(tmp, path), path)
            check(out[path]["degraded"] == {}, f"{path}: degraded sections {out[path]['degraded']}")
    finally:
        if saved is None:
            sys.modules.pop("mlflow", None)
        else:
            sys.modules["mlflow"] = saved
    for path, _ in runs:
        out[path]["kernels"], out[path]["kernel_calls_checked"] = given_kernel_rows(torch, given.pop(path), path,
                                                                                    set())
    t0 = time.perf_counter()
    ts_dir = os.path.join(tmp, "configs_time_series", "report_stats")
    check_files(ts_dir, ["ts_cols_stats.csv", "ts_landscape.csv", "ts_stats.csv", "stability_index.csv",
                         "stabilityIndex_metrics.csv", "ts_daily_utcTimestamp.csv", "ts_hourly_utcTimestamp.csv",
                         "ts_decompose_utcTimestamp.csv", "freqDist_latitude", "ml_anovos_report.html"],
                "configs_time_series")
    det = pd.read_csv(os.path.join(ts_dir, "ts_cols_stats.csv")).set_index("attribute")
    check(list(det.index[det["status"] == "converted"]) == ["utcTimestamp"], "configs_time_series: ts_cols_stats")
    check_runner_stats(checkin_reference(chk, True), ts_dir, id_col="userId", measures=3)
    geo_dir = os.path.join(tmp, "configs_geospatial", "report_stats")
    check_files(geo_dir, geo_files("latitude", "longitude", None) + ["ml_anovos_report.html",
                                                                     "freqDist_utcTimestamp"], "configs_geospatial")
    db = pd.read_csv(os.path.join(geo_dir, "geospatial_dbscan_latitude_longitude.csv"))
    check(db[["eps", "min_samples"]].values.tolist() == [[0.3, 100], [0.3, 300], [0.5, 100], [0.5, 300]]
          and int(db["n_clusters"].max()) >= 2, f"configs_geospatial: DBSCAN grid {db.values.tolist()}")
    check_runner_stats(checkin_reference(chk, False), geo_dir, id_col="userId", measures=3)
    ml_dir = os.path.join(tmp, "configs_mlflow", "report_stats")
    ref = income.drop(columns=["logfnl"]).rename(columns={"marital-status": "marital_status",
                                                          "education-num": "education_num"})
    for c in ("age", "education_num"):
        ref[c] = ref[c].astype(np.float32).astype(np.float64)
    check_runner_stats(ref, ml_dir)
    check_files(ml_dir, ["duplicate_detection.csv", "nullColumns_detection.csv", "freqDist_age", "eventDist_age",
                         "ml_anovos_report.html"], "configs_mlflow")
    for path, _ in runs:
        check(os.path.isfile(os.path.join(tmp, path, "output", "final_dataset", "part-00000.parquet")),
              f"{path}: no final dataset")
    out["configs_feast"]["repo_file_bytes"] = check_feast_run(ref, os.path.join(tmp, "configs_feast"),
                                                              income.iloc[:FEAST_CPU_ROWS], tmp)
    out["checks_s"] = time.perf_counter() - t0
    print(f"checkin configs: files, the DBSCAN grid, utcTimestamp's conversion, the stats CSVs and the feast "
          f"export checked ({out['checks_s']:.1f} s)", flush=True)
    return out


def check_feast_run(ref, run_dir: str, head, tmp: str) -> int:
    """configs_feast's run: its four stats CSVs in phase 3's bands, the
    final dataset one part of the input's rows with the two timestamp
    columns last, and ``anovos.py`` compiling and equal to the one the CPU
    port writes for the same config on ``head`` (its first FEAST_CPU_ROWS
    input rows).  Returns the file's bytes."""
    import pandas as pd

    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.shared.runtime import init_runtime

    check_runner_stats(ref, os.path.join(run_dir, "report_stats"), measures=4)
    parts = [f for f in os.listdir(os.path.join(run_dir, "output", "final_dataset")) if f.startswith("part")]
    check(parts == ["part-00000.parquet"], f"configs_feast: final dataset parts {parts}")
    final = pd.read_parquet(os.path.join(run_dir, "output", "final_dataset", parts[0]))
    ts = ["event_time", "create_time_col"]
    check(len(final) == len(ref) and list(final.columns[-2:]) == ts
          and all(final[c].dtype.kind == "M" and final[c].nunique() == 1 for c in ts),
          f"configs_feast: final dataset {final.dtypes.to_dict()}")
    with open(os.path.join(run_dir, "feast_repo", "anovos.py")) as f:
        text = f.read()
    compile(text, "anovos.py", "exec")
    cpu_in, cpu_run = os.path.join(tmp, "feast_cpu_input"), os.path.join(tmp, "feast_cpu_run")
    os.makedirs(cpu_in)
    head.to_parquet(os.path.join(cpu_in, "part-00000.parquet"), index=False)
    os.makedirs(cpu_run)
    cwd = os.getcwd()
    init_runtime("cpu")
    os.chdir(cpu_run)
    try:
        workflow.main(feast_config(cpu_in), "local")
    finally:
        os.chdir(cwd)
        init_runtime("cuda")
    with open(os.path.join(cpu_run, "feast_repo", "anovos.py")) as f:
        check(f.read() == text, "configs_feast: anovos.py differs from the CPU port's")
    return len(text.encode())


def phase_scenarios(torch, seed: int) -> dict:
    """Phase 11 (11a-c)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"codec": phase_codec(seed, tmp), "configs_yaml": phase_configs_yaml(torch, seed, tmp)}
        out.update(phase_checkin_configs(torch, seed, tmp))
    out["phase_s"] = time.perf_counter() - t0
    print(f"scenarios: phase 11 in {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 12: the geospatial transformers at the income path's scale
# ---------------------------------------------------------------------------
def geo_transform_frame(seed: int, n: int):
    """n rows: a lat/lon pair of six_city_points (1% nulls each); a second
    pair, half of it within 50 km of the first, half uniform over the
    globe, 1% of all rows within 0.05° of the first's antipode; an int id
    with GEO_T_IDS distinct values, the same ids as strings, and a
    positive weight.  Coordinates are f32 values."""
    import pandas as pd

    g = np.random.default_rng(seed)
    pts = six_city_points(g, n)
    lat, lon = pts[:, 0], pts[:, 1]
    near = g.random(n) < 0.5
    step = g.uniform(0, 50_000, n) / 6371009.0 * 180 / np.pi  # degrees of arc
    bearing = g.uniform(0, 2 * np.pi, n)
    lat2 = np.where(near, lat + step * np.cos(bearing), g.uniform(-89, 89, n))
    lon2 = np.where(near, lon + step * np.sin(bearing) / np.cos(np.radians(lat)), g.uniform(-180, 180, n))
    anti = g.random(n) < 0.01
    lat2[anti] = -lat[anti] + g.normal(0, 0.05, anti.sum())
    lon2[anti] = lon[anti] + 180 + g.normal(0, 0.05, anti.sum())
    lon2 = (lon2 + 180) % 360 - 180
    f32 = lambda a: np.clip(a, -180, 180).astype(np.float32).astype(np.float64)  # noqa: E731
    lat, lon, lat2, lon2 = f32(lat), f32(lon), f32(np.clip(lat2, -90, 90)), f32(lon2)
    lat[g.random(n) < 0.01] = np.nan
    lon[g.random(n) < 0.01] = np.nan
    uid = g.permutation(np.arange(n) % GEO_T_IDS) + 7_000_000
    return pd.DataFrame({"latitude": lat, "longitude": lon, "lat2": lat2, "lon2": lon2, "uid": uid,
                         "sid": pd.Series(uid).map("u{}".format).astype(str),
                         "weight": g.uniform(0.5, 2.0, n).astype(np.float32).astype(np.float64)})


def wobbly_ring(lat0: float, lon0: float, r: float, k: int, phase: float) -> list:
    """An open ring (its first vertex not repeated) of k [lon, lat]
    vertices, f32 values, whose radius swings 10% around r seven times a
    turn."""
    t = np.linspace(0, 2 * np.pi, k, endpoint=False)
    rad = r * (1 + 0.1 * np.sin(7 * t + phase))
    return [[float(np.float32(lon0 + a * np.cos(b))), float(np.float32(lat0 + a * np.sin(b)))]
            for a, b in zip(rad, t)]


def geo_polygon_object() -> dict:
    """A FeatureCollection of 2,000 edges over the six-city box: a
    MultiPolygon whose first polygon has a hole, and two polygons that
    overlap each other."""
    return {"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": {"type": "MultiPolygon", "coordinates": [
            [wobbly_ring(37, -100, 8, 600, 0.0), wobbly_ring(37, -100, 3, 300, 1.0)],
            [wobbly_ring(31, -82, 4, 300, 2.0)]]}},
        {"type": "Feature", "geometry": {"type": "Polygon", "coordinates": [wobbly_ring(43, -115, 5, 400, 3.0)]}},
        {"type": "Feature", "geometry": {"type": "Polygon", "coordinates": [wobbly_ring(45, -109, 5, 400, 4.0)]}},
    ]}


def ray_cast_float64(torch, lat, lon, gj: dict):
    """Per-polygon even-odd containment in float64 on the card, the union
    over polygons (holes carve their polygon), and the points whose
    horizontal distance to a crossing edge is under GEO_T_EDGE degrees
    (where f32 and float64 may disagree): (inside, near_edge) bool
    tensors."""
    polys = []
    for feat in gj["features"]:
        geom = feat["geometry"]
        polys += geom["coordinates"] if geom["type"] == "MultiPolygon" else [geom["coordinates"]]
    py_all, px_all = lat.double(), lon.double()
    inside = torch.zeros(len(py_all), dtype=torch.bool, device=lat.device)
    near = torch.zeros_like(inside)
    for poly in polys:
        e = torch.tensor(np.concatenate([np.concatenate([np.asarray(r), np.roll(np.asarray(r), -1, 0)], 1)
                                         for r in poly]), dtype=torch.float64, device=lat.device)
        x1, y1, x2, y2 = (e[:, i][None, :] for i in range(4))
        tile = max(1, (1 << 26) // e.shape[0])
        for s0 in range(0, len(py_all), tile):
            py, px = py_all[s0:s0 + tile, None], px_all[s0:s0 + tile, None]
            straddles = (y1 > py) != (y2 > py)
            xi = x1 + (py - y1) * (x2 - x1) / torch.where(y2 == y1, 1.0, y2 - y1)
            odd = ((straddles & (px < xi)).sum(dim=1) % 2) == 1
            inside[s0:s0 + tile] |= odd
            near[s0:s0 + tile] |= (straddles & ((px - xi).abs() < GEO_T_EDGE)).any(dim=1)
    return inside, near


def float64_centroids(lat, lon, ids, weight=None):
    """pandas float64 groupby of the cartesian vectors (weighted when
    ``weight`` is given) → frame indexed by id: lat, lon, n, and the rows'
    group positions."""
    import pandas as pd

    la, lo = np.radians(lat), np.radians(lon)
    w = np.ones_like(la) if weight is None else weight
    R = 6371009.0
    xyz = pd.DataFrame({"id": ids, "w": w, "x": R * np.cos(la) * np.cos(lo) * w,
                        "y": R * np.cos(la) * np.sin(lo) * w, "z": R * np.sin(la) * w})
    g = xyz.groupby("id", sort=True)
    s = g[["w", "x", "y", "z"]].sum()
    x, y, z = s["x"] / s["w"], s["y"] / s["w"], s["z"] / s["w"]
    return pd.DataFrame({"lat": np.degrees(np.arctan2(z, np.hypot(x, y))), "lon": np.degrees(np.arctan2(y, x)),
                         "n": g.size()})


def phase_geo_transformers(torch, seed: int) -> dict:
    """Phase 12: the eleven geospatial transformers on GEO_T_ROWS rows of
    ``geo_transform_frame`` built in memory with ``Table.from_pandas``,
    each step timed on the host clock ending in a device sync (the dms
    output and input on the first GEO_T_DMS_ROWS rows), then checked
    against float64 numpy/pandas and the port's ``geo_utils``."""
    import pandas as pd

    from anovos_tpu_torch.data_transformer import geo_utils
    from anovos_tpu_torch.data_transformer import geospatial as geo
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.shared.table import Table

    t_phase = time.perf_counter()
    out = {"rows": GEO_T_ROWS, "dms_rows": GEO_T_DMS_ROWS, "ids": GEO_T_IDS}
    walls = out["walls_s"] = {}
    t0 = time.perf_counter()
    df = geo_transform_frame(seed + 15, GEO_T_ROWS)
    t = Table.from_pandas(df)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    gj = geo_polygon_object()
    n_edges = sum(len(r) for f in gj["features"] for p in (f["geometry"]["coordinates"]
                  if f["geometry"]["type"] == "MultiPolygon" else [f["geometry"]["coordinates"]]) for r in p)
    out["polygon_edges"] = n_edges
    with tempfile.TemporaryDirectory() as tmp:
        shape = os.path.join(tmp, "shape.geojson")
        with open(shape, "w") as f:
            json.dump(gj, f)
        kernels.reset_launches()
        ll = dict(list_of_lat="latitude", list_of_lon="longitude")
        rad = timed(torch, walls, "geo_format_latlon radian", lambda: geo.geo_format_latlon(t, **ll, output_format="radian"))
        cart = timed(torch, walls, "geo_format_latlon cartesian",
                     lambda: geo.geo_format_latlon(t, **ll, output_format="cartesian"))
        gh = timed(torch, walls, "geo_format_latlon geohash 9", lambda: geo.geo_format_latlon(
            t, **ll, output_format="geohash", optional_configs={"geohash_precision": 9}))
        head = t.slice_rows(0, GEO_T_DMS_ROWS)
        dms = timed(torch, walls, f"geo_format_latlon dms ({GEO_T_DMS_ROWS} rows)",
                    lambda: geo.geo_format_latlon(head, **ll, output_format="dms"))
        xyz = dict(list_of_x="latitude_longitude_x", list_of_y="latitude_longitude_y",
                   list_of_z="latitude_longitude_z")
        back_cart = timed(torch, walls, "geo_format_cartesian dd",
                          lambda: geo.geo_format_cartesian(cart, **xyz, output_format="dd"))
        back_gh = timed(torch, walls, "geo_format_geohash dd",
                        lambda: geo.geo_format_geohash(gh, "latitude_longitude_geohash", output_format="dd"))
        back_dms = timed(torch, walls, f"geo_format_latlon dms to dd ({GEO_T_DMS_ROWS} rows)",
                         lambda: geo.geo_format_latlon(dms, "latitude_dms", "longitude_dms", input_format="dms",
                                                       output_format="dd"))
        gh5 = timed(torch, walls, "geohash_precision_control 5", lambda: geo.geohash_precision_control(
            gh, "latitude_longitude_geohash", output_precision=5, output_mode="append"))
        dist = {}
        for kind in ("haversine", "vincenty", "euclidean"):
            dist[kind] = timed(torch, walls, f"location_distance {kind} km", lambda: geo.location_distance(
                t, ["latitude", "lat2"], ["longitude", "lon2"], distance_type=kind, unit="km"))
        approx = timed(torch, walls, "location_in_country approx US",
                       lambda: geo.location_in_country(t, "latitude", "longitude", country="US"))
        exact = timed(torch, walls, f"location_in_country exact ({n_edges} edges)", lambda: geo.location_in_country(
            t, "latitude", "longitude", country="XX", country_shapefile_path=shape, method_type="exact"))
        poly = timed(torch, walls, f"location_in_polygon ({n_edges} edges)",
                     lambda: geo.location_in_polygon(t, "latitude", "longitude", gj))
        c_all = timed(torch, walls, "centroid", lambda: geo.centroid(t, "latitude", "longitude"))
        c_uid = timed(torch, walls, "centroid by int id", lambda: geo.centroid(t, "latitude", "longitude", "uid"))
        c_sid = timed(torch, walls, "centroid by string id", lambda: geo.centroid(t, "latitude", "longitude", "sid"))
        wc = timed(torch, walls, "weighted_centroid by int id",
                   lambda: geo.weighted_centroid(t, "latitude", "longitude", "uid", "weight"))
        rog = timed(torch, walls, "rog_calculation by int id",
                    lambda: geo.rog_calculation(t, "latitude", "longitude", "uid"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rg = timed(torch, walls, "reverse_geocoding", lambda: geo.reverse_geocoding(t, "latitude", "longitude"))
        torch.cuda.synchronize()
        out["launches"] = dict(kernels.LAUNCHES)
    out["steps_s"] = sum(walls.values())
    print("geo transformers: walls " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f" (steps {out['steps_s']:.2f} s, set-up {out['setup_s']:.1f} s); launches {out['launches']}", flush=True)
    check(on_card([rad, cart, gh, back_cart, back_gh, gh5, approx, exact, poly, *dist.values()]),
          "a geospatial transformer left the card")
    # the device parts of four steps alone: CUDA-event time of the stream's
    # work, mean of 3 calls after a warm-up (not counted in the walls)
    from anovos_tpu_torch.ops import geo_kernels as gk

    la_d, lo_d = (t.columns[c].data for c in ("latitude", "longitude"))
    la2_d, lo2_d = (t.columns[c].data for c in ("lat2", "lon2"))
    edges = geo._geojson_obj_edges(gj, t.device)
    seg, valid, labels = geo._id_codes(t, "uid")
    xyz_d = gk.latlon_to_cartesian(la_d, lo_d)
    out["device_ms"] = {
        "geohash_digits 9": cuda_ms(torch, lambda: gk.geohash_digits(la_d, lo_d, 9), 3),
        "vincenty": cuda_ms(torch, lambda: gk.vincenty(la_d, lo_d, la2_d, lo2_d), 3),
        f"point_in_polygon_set ({n_edges} edges)": cuda_ms(torch, lambda: gk.point_in_polygon_set(la_d, lo_d, *edges), 3),
        "segment_centroid by int id": cuda_ms(torch, lambda: gk.segment_centroid(*xyz_d, seg, valid, len(labels)), 3),
    }
    del xyz_d, edges, seg, valid
    print("geo transformers: device time " + ", ".join(f"{k} {v:.3f} ms" for k, v in out["device_ms"].items()),
          flush=True)

    t0 = time.perf_counter()
    lat, lon, lat2, lon2 = (df[c].to_numpy(np.float64) for c in ("latitude", "longitude", "lat2", "lon2"))
    ok = ~np.isnan(lat) & ~np.isnan(lon)
    col = lambda tab, c: tab.columns[c].data.cpu().numpy()  # noqa: E731
    mask = lambda tab, c: tab.columns[c].mask.cpu().numpy()  # noqa: E731
    # conversions
    for c, v in (("latitude_radian", lat), ("longitude_radian", lon)):
        check(np.array_equal(mask(rad, c), ok) and np.array_equal(col(rad, c)[ok], np.radians(v[ok]).astype(np.float32)),
              f"{c} is not the f32 of float64 radians")
    R = geo_utils.EARTH_RADIUS_M
    la, lo = np.radians(lat), np.radians(lon)
    for c, v in (("x", R * np.cos(la) * np.cos(lo)), ("y", R * np.cos(la) * np.sin(lo)), ("z", R * np.sin(la))):
        got = col(cart, f"latitude_longitude_{c}")[ok].astype(np.float64)
        check(np.abs(got - v[ok]).max() <= np.spacing(np.float32(R)), f"cartesian {c} off float64")
    err = max(np.abs(col(back_cart, f"latitude_longitude_x_latitude_longitude_y_latitude_longitude_z_{k}")[ok] - v[ok]).max()
              for k, v in (("lat", lat), ("lon", lon)))
    out["cartesian_round_trip_deg"] = float(err)
    check(err <= 6e-6, f"cartesian round trip off by {err} degrees")
    sample = np.random.default_rng(seed).choice(np.flatnonzero(ok), GEO_T_SAMPLE, replace=False)
    strs = geo._host_cat(gh, "latitude_longitude_geohash")
    check(all(strs[i] == geo_utils.geohash_encode(lat[i], lon[i], 9) for i in sample),
          "geohash strings differ from geohash_encode")
    check(all(s is None for s in strs[~ok]), "geohash of a null location")
    for k, v, half in (("latitude", lat, 90.0 / 2 ** 22), ("longitude", lon, 180.0 / 2 ** 23)):
        got = col(back_gh, f"latitude_longitude_geohash_{k}")[ok]
        check(np.abs(got - v[ok]).max() <= half + np.spacing(np.float32(180)), f"geohash {k} centre off the cell")
    p5 = geo._host_cat(gh5, "latitude_longitude_geohash_precision")
    check(all(p5[i] == strs[i][:5] for i in sample), "geohash_precision_control 5")
    okh = ok[:GEO_T_DMS_ROWS]
    for k, v in (("latitude", lat), ("longitude", lon)):
        got = col(back_dms, f"{k}_dms_dd")
        check(np.array_equal(mask(back_dms, f"{k}_dms_dd"), okh)
              and np.array_equal(got[okh], v[:GEO_T_DMS_ROWS][okh].astype(np.float32)),
              f"{k}: dd → dms → dd is not the identity on f32 values")
    # distances against float64 geo_utils, away from the antipode (GAP)
    ok2 = ok  # lat2/lon2 have no nulls
    hav = geo_utils.haversine_distance(lat, lon, lat2, lon2)
    far = ok2 & (np.pi * R - hav > 2e5)
    out["near_antipodal_pairs"] = int((ok2 & ~far).sum())
    vsample = np.flatnonzero(far)[:: max(1, far.sum() // 250_000)]
    refs = {"haversine": (hav, far), "euclidean": (geo_utils.euclidean_distance(lat, lon, lat2, lon2), far),
            "vincenty": (None, vsample)}
    for kind, (ref, sel) in refs.items():
        got = col(dist[kind], f"distance_{kind}").astype(np.float64)
        if ref is None:
            ref = np.full(len(got), np.nan)
            ref[sel] = geo_utils.vincenty_distance(lat[sel], lon[sel], lat2[sel], lon2[sel])
        e = np.abs(got[sel] * 1000 - ref[sel]) - (1e-3 + 1.2e-7 * ref[sel])
        out[f"{kind}_worst_excess_m"] = float(e.max())
        check(np.array_equal(mask(dist[kind], f"distance_{kind}"), ok2) and e.max() <= 0,
              f"{kind}: {int((e > 0).sum())} pairs off float64 beyond the band")
    out["vincenty_checked_pairs"] = len(vsample)
    # containment
    lo_lon, lo_lat, hi_lon, hi_lat = (np.float32(b) for b in geo_utils.COUNTRY_BOUNDING_BOXES["US"][1])
    l32, o32 = lat.astype(np.float32), lon.astype(np.float32)
    box = (l32 >= lo_lat) & (l32 <= hi_lat) & (o32 >= lo_lon) & (o32 <= hi_lon)
    check(np.array_equal(col(approx, "latitude_longitude_in_US")[ok], box[ok].astype(np.float32)), "approx US flags")
    inside, near_edge = (x.cpu().numpy() for x in ray_cast_float64(
        torch, torch.from_numpy(np.nan_to_num(l32)).cuda(), torch.from_numpy(np.nan_to_num(o32)).cuda(), gj))
    keep = ok & ~near_edge
    out["polygon_near_edge_points"] = int((ok & near_edge).sum())
    out["polygon_inside_points"] = int(inside[ok].sum())
    for tab, c in ((exact, "latitude_longitude_in_XX"), (poly, "latitude_longitude_in_poly")):
        got = col(tab, c)
        check(np.array_equal(mask(tab, c), ok) and np.array_equal(got[keep], inside[keep].astype(np.float32)),
              f"{c}: flags differ from the float64 ray cast")
    check(0.05 < inside[ok].mean() < 0.9, f"polygon holds {inside[ok].mean():.3f} of the points")
    # centroids and radii against float64 pandas on the same f32 inputs
    c0 = float64_centroids(lat[ok], lon[ok], np.zeros(ok.sum()))
    check(np.allclose(c_all.to_numpy(np.float64)[0], c0[["lat", "lon"]].to_numpy()[0], atol=1.000001e-6, rtol=0),
          "global centroid")
    uid, sid = df["uid"].to_numpy(), df["sid"].to_numpy()
    ref = float64_centroids(lat[ok], lon[ok], uid[ok])
    check(list(c_uid["uid"]) == list(ref.index) and len(ref) == GEO_T_IDS, "centroid ids")
    err_c = np.abs(c_uid[["latitude_centroid", "longitude_centroid"]].to_numpy() - ref[["lat", "lon"]].to_numpy()).max()
    out["centroid_err_deg"] = float(err_c)
    check(err_c <= 1.000001e-6, f"centroids off float64 by {err_c}")
    by_sid = c_sid.set_index("sid").loc[["u%d" % u for u in c_uid["uid"]]]
    check(np.allclose(by_sid.to_numpy(), c_uid[["latitude_centroid", "longitude_centroid"]].to_numpy(),
                      atol=1.000001e-6, rtol=0), "string-id centroids differ from the int-id ones")
    w = df["weight"].to_numpy()
    wref = float64_centroids(lat[ok], lon[ok], uid[ok], w[ok])
    err_w = np.abs(wc[["latitude_weighted_centroid", "longitude_weighted_centroid"]].to_numpy()
                   - wref[["lat", "lon"]].to_numpy()).max()
    out["weighted_centroid_err_deg"] = float(err_w)
    check(list(wc["uid"]) == list(wref.index) and err_w <= 1.000001e-6, f"weighted centroids off by {err_w}")
    pos = np.searchsorted(ref.index.to_numpy(), uid[ok])
    d = geo_utils.haversine_distance(lat[ok], lon[ok], ref["lat"].to_numpy()[pos], ref["lon"].to_numpy()[pos])
    rog_ref = np.sqrt(np.bincount(pos, d * d) / ref["n"].to_numpy())
    err_r = float(np.abs(rog["rog"].to_numpy() - rog_ref).max() / rog_ref.max())
    out["rog_rel_err"] = err_r
    check(list(rog["uid"]) == list(ref.index) and err_r <= 1e-9, f"rog off float64 by {err_r} relative")
    # reverse geocoding against a float64 brute force on the card
    xyz_c, cities = geo._geocode_table()
    la_t = torch.from_numpy(np.radians(lat[ok])).cuda()
    lo_t = torch.from_numpy(np.radians(lon[ok])).cuda()
    cx = torch.from_numpy(xyz_c.astype(np.float64)).cuda()
    best, margin = [], []
    for s0 in range(0, len(la_t), 1 << 18):
        a, b = la_t[s0:s0 + (1 << 18)], lo_t[s0:s0 + (1 << 18)]
        sc = torch.stack([torch.cos(a) * torch.cos(b), torch.cos(a) * torch.sin(b), torch.sin(a)], 1) @ cx.T
        top = torch.topk(sc, 2, dim=1)
        best.append(top.indices[:, 0])
        margin.append(top.values[:, 0] - top.values[:, 1])
    best, margin = torch.cat(best).cpu().numpy(), torch.cat(margin).cpu().numpy()
    tie = margin <= 4 * np.spacing(np.float32(1))
    out["geocode_near_ties"] = int(tie.sum())
    check(len(rg) == ok.sum() and np.array_equal(rg["latitude"].to_numpy(), lat[ok].astype(np.float32)),
          "reverse_geocoding rows")
    names = cities["name"].to_numpy()[best]
    check(bool((rg["name_of_place"].to_numpy()[~tie] == names[~tie]).all()),
          "reverse_geocoding differs from the float64 nearest city")
    out["checks_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"geo transformers: checked against float64 in {out['checks_s']:.1f} s: radians and cartesian exact/within "
          f"an f32 ulp of the radius, round trips (cartesian {err:.2e}°, dms exact, geohash in the cell), "
          f"{GEO_T_SAMPLE} geohashes equal geohash_encode, distances in band ({out['near_antipodal_pairs']} "
          f"near-antipodal pairs set aside; Vincenty on {len(vsample)} pairs), polygon flags equal float64 but "
          f"{out['polygon_near_edge_points']} points within {GEO_T_EDGE}° of an edge, centroids within {err_c:.1e}° and "
          f"{err_w:.1e}°, rog within {err_r:.1e}, reverse geocoding equal but {out['geocode_near_ties']} near ties; "
          f"phase 12 in {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: out-of-core streaming analysis through the runner
# ---------------------------------------------------------------------------
def stream_folders(df, tmp: str) -> dict:
    """The target folder: STREAM_PARTS parquet parts of STREAM_PART_ROWS
    rows, part i the ``i mod 4``-th slice of phase 3's frame with every
    numeric column shifted by (0.25 + 0.01·⌊i/4⌋)·σ (drift, and parts that
    differ); the source folder: STREAM_SRC_PARTS unshifted parts.  Returns
    the folders, each side's f32 numeric values (k, rows) as the port reads
    them, each side's null counts, the σ of each numeric column and the
    seconds the writing took."""
    num = [c for c in df.columns if df[c].dtype.kind == "f"]
    sigma = {c: float(np.nanstd(df[c].to_numpy(np.float64))) for c in num}
    out = {"num_cols": num, "tgt": os.path.join(tmp, "tgt"), "src": os.path.join(tmp, "src"), "sigma": sigma}
    t0 = time.perf_counter()
    for side, nparts in (("tgt", STREAM_PARTS), ("src", STREAM_SRC_PARTS)):
        os.makedirs(out[side])
        values = np.empty((len(num), nparts * STREAM_PART_ROWS), np.float32)
        nulls = {c: 0 for c in df.columns}
        for i in range(nparts):
            a = (i % 4) * STREAM_PART_ROWS
            part = df.iloc[a:a + STREAM_PART_ROWS].reset_index(drop=True)
            check(len(part) == STREAM_PART_ROWS, "phase 3's frame is too short for the stream parts")
            if side == "tgt":
                part = part.assign(**{c: part[c] + (0.25 + 0.01 * (i // 4)) * sigma[c] for c in num})
            part.to_parquet(os.path.join(out[side], f"part-{i:05d}.parquet"), index=False)
            for j, c in enumerate(num):
                values[j, i * STREAM_PART_ROWS:(i + 1) * STREAM_PART_ROWS] = part[c].to_numpy(
                    np.float32, na_value=np.nan)
            for c, n in part.isna().sum().items():
                nulls[c] += int(n)
        out[side + "_values"], out[side + "_nulls"] = values, nulls
    out["write_s"] = time.perf_counter() - t0
    return out


def stream_config(folders: dict, model: str, report_dir: str, subs=("describe", "quality_missing",
                                                                     "quality_outlier", "drift")) -> dict:
    """A config of one ``streaming_analysis`` block over the target folder
    (no ``input_dataset``): the four sub-analyses, drift against the
    source folder with ``configs_full.yaml``'s drift_statistics options."""
    block = {"file_path": folders["tgt"], "file_type": "parquet", "chunk_rows": STREAM_CHUNK,
             "describe": {}, "quality_missing": {}, "quality_outlier": {"model_path": model},
             "drift": {"source_file_path": folders["src"], **STREAM_DRIFT}}
    return {"streaming_analysis": {k: v for k, v in block.items()
                                   if k in ("file_path", "file_type", "chunk_rows") or k in subs},
            "report_preprocessing": {"master_path": report_dir}}


class PassSummaries:
    """While in its ``with`` block, keeps every streaming pass' published
    summary (``ops/streaming._publish_stats``), in order."""

    def __enter__(self):
        import threading

        from anovos_tpu_torch.ops import streaming

        self.seen, self._orig = [], streaming._publish_stats
        lock = threading.Lock()  # passes on scheduler workers publish at once

        def publish(op, ctl, stats):
            with lock:
                self._orig(op, ctl, stats)
                self.seen.append(streaming.last_stream_summary())

        streaming._publish_stats = publish
        return self

    def __exit__(self, *exc):
        from anovos_tpu_torch.ops import streaming

        streaming._publish_stats = self._orig


def check_stream_describe(path: str, values, cols, quantiles=STREAM_QUANTILES) -> dict:
    """(a) ``stream_describe.csv`` against float64 numpy over the same f32
    values: count, min, max and nonzero exact; the moments within
    tests/test_torch_streaming.py's bands (mean and stddev 1e-5·σ + 5e-5,
    variance 2e-5·var + 1e-4, skewness 1e-4, kurtosis 2e-4 + 1e-4·|k|);
    each quantile within one bin width ((max − min) / 2048) of the value
    at its rank: the count of values below q̂ − w is at most ⌊q(n−1)⌋ and
    the count at or below q̂ + w more than ⌈q(n−1)⌉.  ``values[j]`` holds
    column ``cols[j]``.  Returns the largest error of each moment."""
    import pandas as pd

    got = pd.read_csv(path).set_index("attribute")
    check(list(got.index) == list(cols), f"stream_describe columns {list(got.index)}")
    errs = {k: 0.0 for k in ("mean", "stddev", "variance", "skewness", "kurtosis")}
    for j, c in enumerate(cols):
        v = values[j][~np.isnan(values[j])]
        r = got.loc[c]
        check(int(r["count"]) == len(v) and int(r["nonzero"]) == int(np.count_nonzero(v)),
              f"stream describe count/nonzero of {c}")
        check(np.float32(r["min"]) == v.min() and np.float32(r["max"]) == v.max(),
              f"stream describe min/max of {c}: {r['min']}, {r['max']} vs {v.min()}, {v.max()}")
        ref = f64_moments(v)
        sd = float(np.sqrt(ref["variance"]))
        for k, allow in (("mean", 1e-5 * sd + 5e-5), ("stddev", 1e-5 * sd + 5e-5),
                         ("variance", 2e-5 * ref["variance"] + 1e-4), ("skewness", 1e-4),
                         ("kurtosis", 2e-4 + 1e-4 * abs(ref["kurtosis"]))):
            err = abs(float(r[k]) - (sd if k == "stddev" else ref[k]))
            check(err <= allow, f"stream describe {k} of {c}: {r[k]} off float64 by {err} > {allow}")
            errs[k] = max(errs[k], err)
        w = (float(v.max()) - float(v.min())) / 2048
        for q in quantiles:
            qv = float(r[f"{int(q * 100)}%"])
            pos = q * (len(v) - 1)
            below = int(np.count_nonzero(v < qv - w - 1e-4))
            upto = int(np.count_nonzero(v <= qv + w + 1e-4))
            check(below <= np.floor(pos) and upto > np.ceil(pos),
                  f"stream describe {q} quantile of {c}: {qv} not within a bin width {w}")
    return errs


def check_stream_counts(rdir: str, folders: dict, model: str) -> None:
    """(b) the missing counts against the frames' null counts and the
    outlier counts against numpy's f32 compares, exactly."""
    import pandas as pd

    from anovos_tpu_torch.data_analyzer.quality_checker import _load_outlier_model

    miss = pd.read_csv(os.path.join(rdir, "stream_missing.csv"))
    n = STREAM_PARTS * STREAM_PART_ROWS
    for _, r in miss.iterrows():
        check(int(r["missing_count"]) == folders["tgt_nulls"][r["attribute"]],
              f"stream missing count of {r['attribute']}")
        check(abs(r["missing_pct"] - round(folders["tgt_nulls"][r["attribute"]] / n, 4)) < 1e-9,
              f"stream missing pct of {r['attribute']}")
    out = pd.read_csv(os.path.join(rdir, "stream_outlier.csv"))
    bounds, _ = _load_outlier_model(model)
    check(set(out["attribute"]) == set(bounds), "stream outlier columns")
    for _, r in out.iterrows():
        v = folders["tgt_values"][folders["num_cols"].index(r["attribute"])]
        lo, hi = (np.float32(-np.inf if b is None else b) for b in bounds[r["attribute"]][:2])
        above, below = v > hi, v < lo
        check(int(r["lower_outliers"]) == int(np.count_nonzero(below & ~above))
              and int(r["upper_outliers"]) == int(np.count_nonzero(above & ~below)),
              f"stream outlier counts of {r['attribute']}")


def phase_streaming(torch, seed: int, df, tmp: str) -> dict:
    """Phase 13: ``workflow.main`` on a ``streaming_analysis`` config over
    the folders of ``stream_folders`` (STREAM_PARTS target and STREAM_SRC_PARTS source parts from
    phase 3's frame ``df``, written under ``tmp``) in STREAM_CHUNK-row chunks, then
    checks (a)-(f) and B1 and B2 at the streaming shape.  The folders'
    writing is timed apart.  The folders, the outlier model and the drift
    model stay for phase 14 (``out["feed"]``); the caller removes ``tmp``."""
    import pandas as pd

    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.data_analyzer.quality_checker import outlier_detection
    from anovos_tpu_torch.data_ingest import data_ingest
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
    from anovos_tpu_torch.drift_stability.drift_detector import statistics
    from anovos_tpu_torch.ops import kernels, streaming
    from anovos_tpu_torch.resilience import chaos
    from anovos_tpu_torch.shared.runtime import get_runtime

    out = {}
    dev = get_runtime().device
    cwd = os.getcwd()
    try:
        folders = stream_folders(df, tmp)
        out["write_s"] = folders["write_s"]
        cols = folders["num_cols"]
        print(f"streaming: wrote {STREAM_PARTS} target and {STREAM_SRC_PARTS} source parts of "
              f"{STREAM_PART_ROWS} rows ({len(df.columns)} columns, {len(cols)} numeric) in "
              f"{out['write_s']:.1f} s", flush=True)
        t_phase = time.perf_counter()
        model = os.path.join(tmp, "outlier_model")
        outlier_detection(read_dataset(os.path.join(folders["tgt"], "part-00000.parquet"), "parquet"),
                          list_of_cols="all", drop_cols=["income", "label"], detection_side="both",
                          detection_configs=QUALITY_CONFIG["outlier_detection"]["detection_configs"],
                          model_path=model)
        run_dir = os.path.join(tmp, "run")
        os.makedirs(run_dir)
        os.chdir(run_dir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        kernels.reset_launches()
        # one pass at a time, as before the scheduler: the peak-memory
        # bound (d) is a single pass's window
        with PassSummaries() as passes, executor("sequential"):
            t0 = time.perf_counter()
            workflow.main(stream_config(folders, model, "report_stats"), "local")
            torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t0
        out["launches"] = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base_mem
        out["block_times_s"] = workflow.block_times()
        check(workflow.degraded_sections() == {}, f"streaming degraded: {workflow.degraded_sections()}")
        for name in PATH_KERNELS["streaming"]:
            check(out["launches"][name] > 0, f"kernel {name} was not launched on the streaming path")
        out["passes"] = passes.seen
        for p in passes.seen:
            print(f"streaming: pass {p['op']}: wall {p['wall_s']:.3f} s, decode {p['decode_s']:.3f} s "
                  f"({p['decodes']} parts), fetch wait {p['fetch_wait_s']:.3f} s, drain wait "
                  f"{p['drain_wait_s']:.3f} s, overlap {p['overlap_pct']}, chunks {p['chunks']}, window "
                  f"{p['window']} (high water {p['high_water']}), workers {p['workers']}", flush=True)
        print("streaming: workflow.main {:.3f} s; ".format(out["wall_s"]) + ", ".join(
            f"{k} {v:.3f} s" for k, v in out["block_times_s"].items()) + f"; launches {out['launches']}",
            flush=True)

        # (d) the table never sat on the card whole
        hw = max(p["high_water"] for p in passes.seen)
        allow = (hw + 2) * STREAM_CHUNK * len(cols) * 5 + 256 * 2**20
        out["peak_bytes"], out["peak_allowed_bytes"] = int(peak), int(allow)
        print(f"streaming: (d) peak device memory {peak / 2**20:.1f} MiB, allowed {allow / 2**20:.1f} MiB "
              f"((high water {hw} + 2) x {STREAM_CHUNK} x {len(cols)} x 5 B + 256 MiB); the target alone "
              f"is {STREAM_PARTS * STREAM_PART_ROWS * len(cols) * 5 / 2**20:.0f} MiB", flush=True)
        check(peak <= allow, f"streaming peak device memory {peak} > {allow}")

        t0 = time.perf_counter()
        rdir = os.path.join(run_dir, "report_stats")
        out["moment_errors"] = check_stream_describe(os.path.join(rdir, "stream_describe.csv"),
                                                     folders["tgt_values"], cols)
        check_stream_counts(rdir, folders, model)
        print(f"streaming: (a) describe against float64 (largest errors {out['moment_errors']}), (b) missing "
              f"and outlier counts exact", flush=True)

        # (c) drift against the in-memory statistics of the same rows
        t1 = time.perf_counter()
        tgt_t, src_t = read_dataset(folders["tgt"], "parquet"), read_dataset(folders["src"], "parquet")
        mem = statistics(tgt_t, src_t, **STREAM_DRIFT, use_sampling=False,
                         source_path=os.path.join(tmp, "mem_model"))
        del tgt_t, src_t
        out["in_memory_drift_s"] = time.perf_counter() - t1
        got = pd.read_csv(os.path.join(rdir, "stream_drift.csv"))
        check(list(got["attribute"]) == list(mem["attribute"]), "stream drift columns")
        check(list(got["flagged"]) == list(mem["flagged"]), "stream drift flags")
        drift_err = max(float(np.max(np.abs(got[m].to_numpy(np.float64) - mem[m].to_numpy(np.float64))))
                        for m in ("PSI", "HD", "JSD", "KS"))
        check(drift_err <= 1e-4, f"stream drift off the in-memory statistics by {drift_err}")
        check(got["PSI"].max() > 0, "stream drift: the shifted target shows no drift")
        sm, mm = (os.path.join(d, "drift_statistics") for d in (os.path.join(run_dir, "intermediate_data"),
                                                                 os.path.join(tmp, "mem_model")))
        files = sorted(os.path.relpath(os.path.join(d, f), sm) for d, _, fs in os.walk(sm) for f in fs)
        for rel in files:
            with open(os.path.join(sm, rel), "rb") as a, open(os.path.join(mm, rel), "rb") as b:
                check(a.read() == b.read(), f"stream drift model file {rel} differs from the in-memory one")
        out["drift_max_abs_err"] = drift_err
        print(f"streaming: (c) drift equal to the in-memory statistics of the same "
              f"{(STREAM_PARTS + STREAM_SRC_PARTS) * STREAM_PART_ROWS} rows (metrics within {drift_err:.2e}, "
              f"{len(files)} model files byte-equal, the read and fit {out['in_memory_drift_s']:.1f} s)",
              flush=True)

        # (e) a describe killed after STREAM_KILL_AFTER commits, then resumed
        ck = os.path.join(tmp, "kill_ckpt")
        orig_commit = streaming.StreamCheckpoint.commit
        state = {"n": 0}

        def bomb(self, pass_no, idx, arrays):
            orig_commit(self, pass_no, idx, arrays)
            state["n"] += 1
            if state["n"] == STREAM_KILL_AFTER:
                raise RuntimeError("simulated kill")

        streaming.StreamCheckpoint.commit = bomb
        try:
            streaming.describe_streaming(folders["tgt"], "parquet", chunk_rows=STREAM_CHUNK, checkpoint_dir=ck)
            fail("the simulated kill did not stop the describe pass")
        except RuntimeError as e:
            check("simulated kill" in str(e), f"describe stopped by {e!r}")
        finally:
            streaming.StreamCheckpoint.commit = orig_commit
        reads, orig_read = [], data_ingest.read_host_frame

        def counting(files, *a, **k):
            reads.extend(files)
            return orig_read(files, *a, **k)

        data_ingest.read_host_frame = counting
        try:
            resumed = streaming.describe_streaming(folders["tgt"], "parquet", chunk_rows=STREAM_CHUNK,
                                                   checkpoint_dir=ck, resume=True)
        finally:
            data_ingest.read_host_frame = orig_read
        with open(os.path.join(rdir, "stream_describe.csv")) as f:
            check(resumed.to_csv(index=False) == f.read(), "resumed describe differs from the uninterrupted one")
        check(len(reads) < 2 * STREAM_PARTS, f"resume decoded {len(reads)} parts")
        out["resume_decodes"] = len(reads)
        print(f"streaming: (e) describe killed after {STREAM_KILL_AFTER} commits, resumed: equal to the "
              f"uninterrupted run, {len(reads)} part decodes (a fresh run {2 * STREAM_PARTS})", flush=True)

        # (f) one quality_missing pass with a part corrupt on every read
        os.environ["ANOVOS_TPU_CHAOS"] = f"corrupt@io:*part-{STREAM_CHAOS_PART:05d}.parquet:n=99"
        try:
            fdir = os.path.join(tmp, "chaos_run")
            os.makedirs(fdir)
            os.chdir(fdir)
            workflow.main(stream_config(folders, model, "report_stats", subs=("quality_missing",)), "local")
        finally:
            del os.environ["ANOVOS_TPU_CHAOS"]
            chaos.reset()
            os.chdir(run_dir)
        with open(os.path.join(fdir, "report_stats", "obs", "quarantine_manifest.json")) as f:
            man = json.load(f)
        check(man["parts"] == 1 and man["rows_lost"] == STREAM_PART_ROWS
              and os.path.basename(man["records"][0]["file"]) == f"part-{STREAM_CHAOS_PART:05d}.parquet",
              f"quarantine manifest {man}")
        miss = pd.read_csv(os.path.join(fdir, "report_stats", "stream_missing.csv"))
        lost = df.iloc[(STREAM_CHAOS_PART % 4) * STREAM_PART_ROWS:(STREAM_CHAOS_PART % 4 + 1) * STREAM_PART_ROWS]
        lost_nulls = lost.isna().sum()
        for _, r in miss.iterrows():
            check(int(r["missing_count"]) == folders["tgt_nulls"][r["attribute"]] - int(lost_nulls[r["attribute"]]),
                  f"chaos missing count of {r['attribute']}")
        print(f"streaming: (f) part-{STREAM_CHAOS_PART:05d} corrupt on every read: quarantined with "
              f"{man['rows_lost']} rows lost, the missing counts equal numpy's over the other "
              f"{STREAM_PARTS - 1} parts", flush=True)
        out["checks_s"] = time.perf_counter() - t0

        # B1 and B2 at the streaming shape: part 0's chunk block, B2 on the
        # fitted drift cutoffs
        first = pd.read_parquet(os.path.join(folders["tgt"], "part-00000.parquet"))
        staging = streaming._Staging(len(cols), STREAM_CHUNK, dev)
        _slot, xv, mv = staging.fill(first, cols)
        Xc, Mc = xv.to(dev), mv.to(dev)
        bins = pd.read_parquet(os.path.join(sm, "attribute_binning", "part-00000.parquet"))
        kcols = [cols.index(c) for c in bins["attribute"]]
        cuts = torch.tensor(np.stack([np.asarray(p, np.float32) for p in bins["parameters"]]), device=dev)
        Xh, Mh = Xc[kcols].contiguous(), Mc[kcols].contiguous()
        out["kernels"] = {"masked_moments": [b1_row(torch, Xc, Mc, "streaming", "part 0's chunk")],
                          "binned_histograms": [b2_row(torch, Xh, Mh, cuts, STREAM_DRIFT["bin_size"],
                                                       "streaming", "part 0's chunk, the drift cutoffs")]}
        del Xc, Mc, Xh, Mh
        out["phase_s"] = time.perf_counter() - t_phase
        out["feed"] = {"folders": folders, "model": model, "drift_model": sm,
                       "drift_csv": os.path.join(rdir, "stream_drift.csv")}
    finally:
        os.chdir(cwd)
    print(f"streaming: phase 13 in {out['phase_s']:.1f} s (writing apart: {out['write_s']:.1f} s), "
          f"checks {out['checks_s']:.1f} s", flush=True)
    return out


def continuum_feed(folders: dict, root: str) -> str:
    """The continuum's feed directory: phase 13's source parts hard-linked
    as ``base-0000i.parquet`` (the drift baseline) and its target parts as
    ``day-000ii.parquet``, no byte rewritten."""
    feed = os.path.join(root, "feed")
    os.makedirs(feed)
    for side, prefix, n in (("src", "base", STREAM_SRC_PARTS), ("tgt", "day", STREAM_PARTS)):
        for i in range(n):
            os.link(os.path.join(folders[side], f"part-{i:05d}.parquet"),
                    os.path.join(feed, f"{prefix}-{i:05d}.parquet"))
    return feed


def continuum_section(feed: str, root: str, model: str) -> dict:
    """The ``continuous_analysis`` section: every column, phase 13's
    outlier model, drift fitted from the baseline days."""
    return {"dataset_path": feed, "state_dir": os.path.join(root, "state"),
            "output_path": os.path.join(root, "out"), "outlier_model_path": model,
            "drift": dict(CONTINUUM_DRIFT)}


def continuum_step(torch, cfg, what: str):
    """One ``continuum.step`` on the card: (summary, the kernel launches it
    made, its wall on the host clock ending in a device sync, the parts it
    decoded)."""
    from anovos_tpu_torch import continuum
    from anovos_tpu_torch.data_ingest import data_ingest
    from anovos_tpu_torch.ops import kernels

    decodes, orig = [], data_ingest.read_host_frame

    def counting(files, *a, **k):
        decodes.extend(files)
        return orig(files, *a, **k)

    data_ingest.read_host_frame = counting
    kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        s = continuum.step(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        data_ingest.read_host_frame = orig
    launches = dict(kernels.LAUNCHES)
    print(f"continuum: ({what}) step {wall:.3f} s: folded {len(s['folded'])}, refolded {len(s['refolded'])}, "
          f"quarantined {s['quarantined']}, model fitted {s['model_fitted']}, alerts {s['alerts']}, "
          f"{len(decodes)} decodes, walls {s['walls_s']}, rendered {s['sections_rendered']}, "
          f"launches {launches}", flush=True)
    return s, launches, wall, len(decodes)


def check_continuum_counts(out_dir: str, folders: dict, model: str, df) -> None:
    """The missing counts against both sides' null counts, the outlier
    counts against numpy's f32 compares over both sides' values, and the
    categorical summary against pandas value counts of the slices the
    parts hold, exactly."""
    import pandas as pd

    from anovos_tpu_torch.data_analyzer.quality_checker import _load_outlier_model

    n = (STREAM_PARTS + STREAM_SRC_PARTS) * STREAM_PART_ROWS
    miss = pd.read_csv(os.path.join(out_dir, "continuum_missing.csv"))
    check(sorted(miss["attribute"]) == sorted(df.columns), "continuum missing columns")
    for _, r in miss.iterrows():
        nulls = folders["tgt_nulls"][r["attribute"]] + folders["src_nulls"][r["attribute"]]
        check(int(r["missing_count"]) == nulls and abs(r["missing_pct"] - round(nulls / n, 4)) < 1e-9,
              f"continuum missing count of {r['attribute']}")
    out = pd.read_csv(os.path.join(out_dir, "continuum_outlier.csv"))
    bounds, _ = _load_outlier_model(model)
    check(set(out["attribute"]) == set(bounds), "continuum outlier columns")
    for _, r in out.iterrows():
        j = folders["num_cols"].index(r["attribute"])
        lo, hi = (np.float32(-np.inf if b is None else b) for b in bounds[r["attribute"]][:2])
        n_lo = n_hi = 0
        for v in (folders["tgt_values"][j], folders["src_values"][j]):
            above, below = v > hi, v < lo
            n_lo += int(np.count_nonzero(below & ~above))
            n_hi += int(np.count_nonzero(above & ~below))
        check(int(r["lower_outliers"]) == n_lo and int(r["upper_outliers"]) == n_hi,
              f"continuum outlier counts of {r['attribute']}")
    # part i of either side holds slice i mod 4 of the frame (the target's
    # numeric columns shifted, its categorical ones as they are)
    mult = [sum(1 for n in (STREAM_PARTS, STREAM_SRC_PARTS) for i in range(n) if i % 4 == s) for s in range(4)]
    cat = pd.read_csv(os.path.join(out_dir, "continuum_categorical.csv"), dtype=str, keep_default_na=False)
    cat_cols = [c for c in df.columns if df[c].dtype.kind not in "fiub"]
    check(list(cat["attribute"]) == sorted(cat_cols), f"continuum categorical columns {list(cat['attribute'])}")
    for _, r in cat.iterrows():
        cnt = {}
        for s, m in enumerate(mult):
            sl = df[r["attribute"]].iloc[s * STREAM_PART_ROWS:(s + 1) * STREAM_PART_ROWS]
            for v, c in sl.dropna().astype(str).value_counts().items():
                cnt[v] = cnt.get(v, 0) + m * int(c)
        top = max(sorted(cnt), key=lambda v: cnt[v])
        check(int(r["distinct"]) == len(cnt) and r["top_value"] == top and int(r["top_count"]) == cnt[top],
              f"continuum categorical summary of {r['attribute']}: {dict(r)} vs {len(cnt)}, {top}, {cnt[top]}")


def check_continuum_model(cm: str, sm: str) -> dict:
    """The drift model fitted from the baseline days (``cm``) against phase
    13's streaming model fitted from the same 8 source parts (``sm``): the
    same attributes with bit-equal cutoffs; each of the streaming model's
    frequency files present, its keys the continuum's plus the
    target-only values (p = 0), and every p equal once both are f32.  The
    two fitters of the reference write their files differently (the
    continuum's binning rows in name order, the streaming fit's in column
    order; the continuum's p a float64 quotient over the source values,
    the streaming fit's an f32 quotient over the union vocabulary), so
    they are not byte-equal; the count of files that are is returned."""
    import pandas as pd

    bins = os.path.join("attribute_binning", "part-00000.parquet")
    got, exp = (pd.read_parquet(os.path.join(m, bins)) for m in (cm, sm))
    check(sorted(got["attribute"]) == sorted(exp["attribute"]), "continuum binning model attributes")
    cuts = dict(zip(got["attribute"], got["parameters"]))
    check(all(np.array_equal(np.asarray(cuts[c], np.float64), np.asarray(p, np.float64))
              for c, p in zip(exp["attribute"], exp["parameters"])),
          "continuum binning model's cutoffs differ from phase 13's streaming fit")
    with open(os.path.join(cm, bins), "rb") as a, open(os.path.join(sm, bins), "rb") as b:
        same = int(a.read() == b.read())
    base = os.path.join(sm, "frequency_counts")
    files = 0
    for c in sorted(os.listdir(base)):
        rel = os.path.join("frequency_counts", c, "part-00000.csv")
        check(os.path.exists(os.path.join(cm, rel)), f"continuum model lacks {rel}")
        with open(os.path.join(cm, rel), "rb") as a, open(os.path.join(sm, rel), "rb") as b:
            same += a.read() == b.read()
        got = pd.read_csv(os.path.join(cm, rel), dtype=str)
        exp = pd.read_csv(os.path.join(sm, rel), dtype=str)
        gp = dict(zip(got[c], got["p"].astype(float)))
        ep = dict(zip(exp[c], exp["p"].astype(float)))
        check(set(gp) <= set(ep) and all(ep[k] == 0 for k in set(ep) - set(gp)),
              f"continuum model frequency keys of {c}")
        check(all(np.float32(gp[k]) == np.float32(ep[k]) for k in gp), f"continuum model frequencies of {c}")
        files += 1
    return {"frequency_files": files, "byte_equal": same}


def phase_continuum(torch, seed: int, df, feed_in: dict, tmp: str) -> dict:
    """Phase 14: the continuum over phase 13's 24 parts of STREAM_PART_ROWS rows
    hard-linked as daily partitions (8 baseline days, 16 target days),
    through ``anovos_tpu_torch.continuum.step``: (a) the catch-up step,
    (b) one new day shifted a further CONTINUUM_SHIFT σ, (c) a step with
    no arrival, (d) a corrupt day, (e) a kill after one day's fold commit
    in a CLI subprocess and the resume.  Then the checks and B1 and B2 on
    day 0's block."""
    import pandas as pd

    from anovos_tpu_torch.continuum.sufficient import FoldContext, PartFrame
    from anovos_tpu_torch.continuum.watcher import ContinuumConfig
    from anovos_tpu_torch.ops.hll import hll_registers, precision_for_rsd

    folders = feed_in["folders"]
    root = os.path.join(tmp, "continuum")
    os.makedirs(root)
    feed = continuum_feed(folders, root)
    section = continuum_section(feed, root, feed_in["model"])
    cfg = ContinuumConfig.from_dict(section)
    out = {"walls_s": {}, "launches": {}}
    t_phase = time.perf_counter()
    n_parts = STREAM_SRC_PARTS + STREAM_PARTS

    # (a) the catch-up: baseline folds, the model fit with one re-decode of
    # the baseline, the target days binned over it
    s, la, wall, dec = continuum_step(torch, cfg, "a: catch-up")
    out["walls_s"]["a"], out["steps"] = wall, {"a": s["walls_s"]}
    check(len(s["folded"]) == n_parts and s["model_fitted"] and not s["quarantined"] and not s["refolded"],
          f"continuum catch-up summary {s}")
    check(dec == n_parts + STREAM_SRC_PARTS, f"continuum catch-up decoded {dec} parts")
    check(la["masked_moments"] == n_parts and la["binned_histograms"] == n_parts
          and la["neighbor_counts"] == 0, f"continuum catch-up launches {la}")
    out["launches"]["a"] = la

    t0 = time.perf_counter()
    out_dir = cfg.output_path
    cols = folders["num_cols"]
    both = [np.concatenate([folders["src_values"][j], folders["tgt_values"][j]]) for j in range(len(cols))]
    order = sorted(range(len(cols)), key=lambda j: cols[j])
    out["moment_errors"] = check_stream_describe(os.path.join(out_dir, "continuum_stats.csv"),
                                                 [both[j] for j in order], [cols[j] for j in order],
                                                 quantiles=())
    del both
    check_continuum_counts(out_dir, folders, feed_in["model"], df)
    out["model"] = check_continuum_model(os.path.join(cfg.state_dir, "drift_model"), feed_in["drift_model"])
    got = pd.read_csv(os.path.join(out_dir, "continuum_drift.csv")).set_index("attribute")
    exp = pd.read_csv(feed_in["drift_csv"]).set_index("attribute")
    common = [c for c in exp.index if c in got.index]
    check(len(common) == len(exp), f"continuum drift attributes {list(got.index)} vs {list(exp.index)}")
    check(list(got.loc[common, "flagged"]) == list(exp.loc[common, "flagged"]), "continuum drift flags")
    out["drift_max_abs_err"] = max(float(np.max(np.abs(got.loc[common, m].to_numpy(np.float64)
                                                       - exp.loc[common, m].to_numpy(np.float64))))
                                   for m in ("PSI", "HD", "JSD", "KS"))
    # one unit of the 4th decimal: the two fitters' p differ in their last
    # bits (f32 and float64 quotients), which may round a metric the other way
    check(out["drift_max_abs_err"] <= 1e-4 + 1e-12,
          f"continuum drift off phase 13's by {out['drift_max_abs_err']}")
    # day 0's HLL registers against the CPU's, from the frame as decoded
    with open(os.path.join(cfg.state_dir, "state_manifest.json")) as f:
        npz = json.load(f)["parts"]["day-00000.parquet"]["npz"]
    with np.load(os.path.join(cfg.state_dir, "parts", npz)) as z:
        regs, hcols = z["hll__registers"], [str(c) for c in z["hll__cols"]]
    day0 = pd.read_parquet(os.path.join(feed, "day-00000.parquet"))
    X = day0[hcols].to_numpy(np.float32, na_value=np.nan)
    cpu = hll_registers(torch.from_numpy(np.nan_to_num(X, nan=0.0)), torch.from_numpy(~np.isnan(X)),
                        precision_for_rsd(0.05)).numpy()
    check(np.array_equal(regs, cpu), "continuum HLL registers of day 0 differ from the CPU's")
    out["checks_s"] = time.perf_counter() - t0
    print(f"continuum: (a) checked in {out['checks_s']:.1f} s: stats against float64 (largest errors "
          f"{out['moment_errors']}), missing, outlier and categorical counts exact, the fitted model against "
          f"phase 13's ({out['model']}), drift within {out['drift_max_abs_err']:.2e} of phase 13's, day 0's "
          f"HLL registers equal to the CPU's", flush=True)

    # (b) one new day, a target part shifted a further CONTINUUM_SHIFT σ:
    # only it decodes and folds, and its drift alert fires
    i = STREAM_PARTS
    part = df.iloc[(i % 4) * STREAM_PART_ROWS:(i % 4 + 1) * STREAM_PART_ROWS].reset_index(drop=True)
    shift = 0.25 + 0.01 * (i // 4) + CONTINUUM_SHIFT
    new_day = f"day-{i:05d}.parquet"
    t0 = time.perf_counter()
    part.assign(**{c: part[c] + shift * folders["sigma"][c] for c in cols}).to_parquet(
        os.path.join(feed, new_day), index=False)
    out["arrival_write_s"] = time.perf_counter() - t0
    s, lb, wall, dec = continuum_step(torch, cfg, "b: one arrival")
    out["walls_s"]["b"], out["steps"]["b"] = wall, s["walls_s"]
    out["arrival_artifact_lag_s"] = wall
    check(s["folded"] == [new_day] and dec == 1 and not s["model_fitted"], f"continuum arrival summary {s}")
    check(lb["masked_moments"] == 1 and lb["binned_histograms"] == 1, f"continuum arrival launches {lb}")
    out["launches"]["b"] = lb
    with open(os.path.join(out_dir, "obs", "continuum_alerts.jsonl")) as f:
        alerts = [json.loads(line) for line in f]
    drift = [a for a in alerts if a["kind"] == "drift" and a["partition"] == new_day]
    check(bool(drift) and all(a["value"] > a["threshold"] and a["flight"] for a in drift),
          f"continuum arrival drift alerts {drift[:2]}")
    out["arrival_alerts"] = len(drift)

    # (c) no arrival: nothing decodes, folds, launches or renders
    s, lc, wall, dec = continuum_step(torch, cfg, "c: no arrival")
    out["walls_s"]["c"] = wall
    check(s["folded"] == [] and dec == 0 and s["sections_rendered"] == [] and not any(lc.values()),
          f"continuum idle step {s}, launches {lc}")

    # (d) a corrupt day: quarantined with its alert, nothing launched
    bad = f"day-{i + 1:05d}.parquet"
    with open(os.path.join(feed, bad), "wb") as f:
        f.write(b"NOTPARQUET" * 1000)
    s, ld, wall, dec = continuum_step(torch, cfg, "d: a corrupt day")
    out["walls_s"]["d"] = wall
    check(s["quarantined"] == [bad] and s["folded"] == [] and not any(ld.values()), f"continuum corrupt day {s}")
    with open(os.path.join(out_dir, "obs", "continuum_alerts.jsonl")) as f:
        check(any(json.loads(line)["kind"] == "quarantine" and json.loads(line)["partition"] == bad for line in f),
              "continuum quarantine alert")

    # (e) two more days; a CLI step killed after the first one's fold
    # commit (before its snapshot), then a CLI step that resumes
    late = [f"day-{i + 2:05d}.parquet", f"day-{i + 3:05d}.parquet"]
    for j, name in enumerate(late):
        os.link(os.path.join(folders["tgt"], f"part-{j + 1:05d}.parquet"), os.path.join(feed, name))
    conf = os.path.join(root, "continuum.yaml")
    with open(conf, "w") as f:
        json.dump({"continuous_analysis": section}, f)  # JSON is YAML
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    env.pop("ANOVOS_TPU_CHAOS", None)
    cli = [*CONTINUUM_CLI, "step", "--json", "--config", conf]
    t0 = time.perf_counter()
    kill = subprocess.run(cli, cwd=repo, capture_output=True, text=True, timeout=300,
                          env={**env, "ANOVOS_TPU_CHAOS": f"exc@continuum:fold_committed:{late[0]}:n=1"})
    out["walls_s"]["e_kill"] = time.perf_counter() - t0
    check(kill.returncode != 0 and "ChaosError" in kill.stderr, f"continuum kill: rc {kill.returncode}, "
          f"{kill.stderr[-800:]}")
    t0 = time.perf_counter()
    res = subprocess.run(cli, cwd=repo, capture_output=True, text=True, timeout=300, env=env)
    out["walls_s"]["e_resume"] = time.perf_counter() - t0
    check(res.returncode == 0, f"continuum resume: rc {res.returncode}, {res.stderr[-800:]}")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    check(summary["folded"] == late[1:], f"continuum resume folded {summary['folded']}")
    with open(os.path.join(cfg.state_dir, "continuum_journal.jsonl")) as f:
        commits = [json.loads(line).get("part") for line in f if '"fold_commit"' in line]
    twice = sorted({p for p in commits if commits.count(p) > 1})
    check(not twice and len(commits) == n_parts + 3, f"continuum fold commits: {len(commits)}, twice {twice}")
    print(f"continuum: (e) a CLI step killed after {late[0]}'s fold commit ({out['walls_s']['e_kill']:.1f} s), "
          f"resumed by another ({out['walls_s']['e_resume']:.1f} s): it folded {summary['folded']}, every "
          f"part has one fold commit ({len(commits)})", flush=True)

    # B1 and B2 on day 0's block, B2 on the fitted model's cutoffs
    block = PartFrame(day0, FoldContext(list_of_cols="all"))
    Xc, Mc = block.device_block()
    bins = pd.read_parquet(os.path.join(cfg.state_dir, "drift_model", "attribute_binning", "part-00000.parquet"))
    kcols = [block.num_cols.index(c) for c in bins["attribute"]]
    cuts = torch.tensor(np.stack([np.asarray(p, np.float32) for p in bins["parameters"]]), device=Xc.device)
    out["kernels"] = {"masked_moments": [b1_row(torch, Xc, Mc, "continuum", "day 0's block")],
                      "binned_histograms": [b2_row(torch, Xc[kcols].contiguous(), Mc[kcols].contiguous(), cuts,
                                                   CONTINUUM_DRIFT["bin_size"], "continuum",
                                                   "day 0's block, the fitted cutoffs")]}
    del Xc, Mc, block
    out["path_launches"] = {k: la[k] + lb[k] for k in la}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"continuum: phase 14 in {out['phase_s']:.1f} s (catch-up {out['walls_s']['a']:.1f} s, arrival to "
          f"artifact {out['arrival_artifact_lag_s']:.2f} s), launches on the path {out['path_launches']}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the feature recommender, the sequential executor against the
# concurrent one, and a chaos hang the watchdog degrades
# ---------------------------------------------------------------------------
def recommender_calls(fe, fm) -> list:
    """(name, call) for every public function of the explorer and the
    mapper and for ``sankey_visualization`` (its four layer cases and the
    relevance mapping's), on REC_ATTRS and REC_TARGETS."""
    ind, uc = REC_QUERY
    calls = [("list_all_industry", fe.list_all_industry), ("list_all_usecase", fe.list_all_usecase),
             ("list_all_pair", fe.list_all_pair)]
    for semantic in (False, True):
        q_ind, q_uc = (ind, uc) if not semantic else REC_MISSPELT
        calls += [
            (f"process_industry[{semantic}]", lambda q=q_ind, s=semantic: fe.process_industry(q, s)),
            (f"process_usecase[{semantic}]", lambda q=q_uc, s=semantic: fe.process_usecase(q, s)),
            (f"list_usecase_by_industry[{semantic}]",
             lambda q=q_ind, s=semantic: fe.list_usecase_by_industry(q, s)),
            (f"list_industry_by_usecase[{semantic}]",
             lambda q=q_uc, s=semantic: fe.list_industry_by_usecase(q, s)),
            (f"list_feature_by_industry[{semantic}]",
             lambda q=q_ind, s=semantic: fe.list_feature_by_industry(q, 20, s)),
            (f"list_feature_by_usecase[{semantic}]",
             lambda q=q_uc, s=semantic: fe.list_feature_by_usecase(q, 20, s)),
            (f"list_feature_by_pair[{semantic}]",
             lambda a=q_ind, b=q_uc, s=semantic: fe.list_feature_by_pair(a, b, 20, s))]
    calls += [("feature_mapper", lambda: fm.feature_mapper(REC_ATTRS, top_n=3, threshold=0.0)),
              ("find_attr_by_relevance",
               lambda: fm.find_attr_by_relevance(REC_ATTRS, REC_TARGETS, threshold=0.0))]
    return calls


def same_result(got, exp) -> float:
    """0.0 when a recommender result equals the reference, else fails;
    similarity scores (the floats of a frame, the sankey's link values)
    may differ by one unit of their 4th decimal where the float64 products
    of the two devices round across it: returns the largest such
    difference."""
    import pandas as pd

    if isinstance(exp, pd.DataFrame):
        check(list(got.columns) == list(exp.columns) and len(got) == len(exp), "frame shape")
        err = 0.0
        for c in exp.columns:
            if pd.api.types.is_float_dtype(exp[c]):
                d = float(np.max(np.abs(got[c].to_numpy(np.float64) - exp[c].to_numpy(np.float64)), initial=0))
                check(d <= 1e-4 + 1e-12, f"{c} differs by {d}")
                err = max(err, d)
            else:
                check(got[c].astype(str).tolist() == exp[c].astype(str).tolist(), f"column {c} differs")
        return err
    if isinstance(exp, dict):  # a sankey figure
        g, e = got["data"][0], exp["data"][0]
        check(g["node"] == e["node"] and got["layout"] == exp["layout"]
              and g["link"]["source"] == e["link"]["source"] and g["link"]["target"] == e["link"]["target"],
              "sankey nodes or links differ")
        d = float(np.max(np.abs(np.subtract(g["link"]["value"], e["link"]["value"])), initial=0))
        check(d <= 1e-4 + 1e-12, f"sankey values differ by {d}")
        return d
    check(got == exp, f"{got!r} != {exp!r}")
    return 0.0


def phase_recommender(torch) -> dict:
    """Phase 15a: the feature recommender at full width, the whole shipped
    corpus (1,684 rows), under each weight-free backend: every call of
    ``recommender_calls`` and the sankeys of the two mappings on the card,
    then on the CPU port, each call's wall kept; the results equal; the
    cosine self-similarity of the grouped corpus' 1,433 feature texts
    (float64 on each device) within 1e-12 of the CPU's."""
    from anovos_tpu_torch.feature_recommender import featrec_init as fi
    from anovos_tpu_torch.feature_recommender import feature_explorer as fe
    from anovos_tpu_torch.feature_recommender import feature_mapper as fm
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.shared.runtime import init_runtime

    out = {"backends": {}}
    t_phase = time.perf_counter()
    kernels.reset_launches()
    saved = os.environ.get("FR_BACKEND")
    try:
        for backend in ("tfidf", "hashed"):
            os.environ["FR_BACKEND"] = backend
            res, walls, sims = {}, {}, {}
            for dev in ("cuda", "cpu"):
                init_runtime(dev)
                fi.reset_model()
                res[dev], walls[dev] = {}, {}
                for name, call in recommender_calls(fe, fm):
                    t0 = time.perf_counter()
                    res[dev][name] = call()
                    torch.cuda.synchronize()
                    walls[dev][name] = time.perf_counter() - t0
                for mapping in ("feature_mapper", "find_attr_by_relevance"):
                    for ind_l, uc_l in ((False, False), (True, False), (False, True), (True, True)):
                        name = f"sankey_visualization[{mapping},{ind_l},{uc_l}]"
                        t0 = time.perf_counter()
                        res[dev][name] = fm.sankey_visualization(res[dev][mapping], ind_l, uc_l)
                        walls[dev][name] = time.perf_counter() - t0
                texts, _ = fi.feature_recommendation_prep()
                model = fi.get_model()
                model.fit_corpus(texts)
                emb = model.encode(texts)
                t0 = time.perf_counter()
                sims[dev] = fi.cosine_sim_matrix(emb, emb)
                torch.cuda.synchronize()
                walls[dev]["cosine_sim_matrix"] = time.perf_counter() - t0
            check(model.backend == backend, f"backend {model.backend}, asked {backend}")
            score_err = max(same_result(res["cuda"][n], res["cpu"][n]) for n in res["cpu"])
            cos_err = float(np.max(np.abs(sims["cuda"] - sims["cpu"])))
            check(sims["cuda"].dtype == np.float64 and sims["cuda"].shape == (len(texts), len(texts)),
                  f"cosine matrix {sims['cuda'].dtype} {sims['cuda'].shape}")
            check(cos_err <= 1e-12, f"{backend}: the card's cosine matrix is {cos_err:.3e} off the CPU's")
            mapping = res["cuda"]["feature_mapper"]
            check(len(mapping) == 3 * len(REC_ATTRS), f"{backend}: {len(mapping)} mapped rows")
            out["backends"][backend] = {
                "calls": len(res["cuda"]), "cosine_max_abs_err": cos_err, "score_max_abs_err": score_err,
                "card_s": walls["cuda"], "cpu_s": walls["cpu"],
                "top_match": {a: str(mapping.loc[mapping["Attribute Name"] == a, "Feature Name"].iloc[0])
                              for a in REC_ATTRS}}
            print(f"recommender[{backend}]: {len(res['cuda'])} calls on the card equal the CPU port's "
                  f"(scores within {score_err:.1e}); cosine {len(texts)} x {len(texts)} float64 within "
                  f"{cos_err:.3e} of the CPU's, {walls['cuda']['cosine_sim_matrix'] * 1e3:.2f} ms on the card "
                  f"against {walls['cpu']['cosine_sim_matrix'] * 1e3:.2f} ms; walls on the card: "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in walls["cuda"].items()), flush=True)
            print(f"recommender[{backend}]: CPU walls: "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in walls["cpu"].items()), flush=True)
    finally:
        init_runtime("cuda")
        fi.reset_model()
        if saved is None:
            os.environ.pop("FR_BACKEND", None)
        else:
            os.environ["FR_BACKEND"] = saved
    out["launches"] = dict(kernels.LAUNCHES)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def phase_sequential(torch, runner: dict, full_runner: dict, root: str) -> dict:
    """Phase 15b: configs_basic (phase 9's input) and configs_full (10d's
    input) again under ``ANOVOS_TPU_EXECUTOR=sequential``: every file,
    the HTML included, byte-equal to phase 9's and 10d's runs in the
    default (concurrent) mode; the same schedule and B1 and B2 launch
    counts in both modes; each launch against its plain version on the
    inputs the runner gave it; both modes' schedule summaries, block walls
    and peak device memory printed."""
    from anovos_tpu_torch.parallel.scheduler import available_cpus

    out = {}
    for what, cfg, conc in (
            ("configs_basic", basic_config(runner["main_dir"], runner["join_dir"]), runner),
            ("configs_full", full_config(full_runner["main_dir"], full_runner["si_dirs"]), full_runner)):
        run_dir = os.path.join(root, f"{what}_sequential")
        with KernelInputs(torch) as given, executor("sequential"):
            seq = run_measured(torch, cfg, run_dir)
        conc_launches = conc["launches"] if "launches" in conc else conc["launches_by_step"]["workflow.main"]
        check(seq["schedule"]["mode"] == "sequential", f"{what}: {seq['schedule']['mode']}")
        if available_cpus() > 1:
            check(conc["schedule"]["mode"] == "concurrent", f"{what}: the default mode ran "
                  f"{conc['schedule']['mode']} on {available_cpus()} CPUs")
        check(seq["degraded"] == {}, f"{what}: degraded {seq['degraded']}")
        check(set(seq["tree"]) == set(conc["tree"]),
              f"{what}: files of one mode only: {sorted(set(seq['tree']) ^ set(conc['tree']))[:8]}")
        differ = sorted(p for p in seq["tree"] if seq["tree"][p] != conc["tree"][p])
        check(not differ, f"{what}: files differ between the modes: {differ[:8]}")
        check(any(p.endswith("ml_anovos_report.html") for p in seq["tree"]), f"{what}: no report")
        check(seq["schedule"]["deps"] == conc["schedule"]["deps"], f"{what}: the schedules differ")
        check(seq["launches"] == conc_launches, f"{what}: launches {seq['launches']} sequential, "
              f"{conc_launches} concurrent")
        check(not seq["schedule"]["on_stream"], f"{what}: sequential nodes on streams")
        for name, calls in given.seen.items():
            check(len(calls) == seq["launches"][name], f"{what}: {len(calls)} {name} calls recorded")
        shapes = {tuple(a[0].shape) for calls in given.seen.values() for a in calls}
        _, checked = given_kernel_rows(torch, given, f"sequential {what}", shapes)
        del given
        shutil.rmtree(run_dir, ignore_errors=True)
        print_schedule(f"{what} sequential", seq)
        print_schedule(f"{what} concurrent", conc)
        print(f"{what}: sequential block walls " + ", ".join(f"{k} {v:.3f} s" for k, v in seq["block_times_s"].items())
              + f"; concurrent block walls " + ", ".join(f"{k} {v:.3f} s" for k, v in conc["block_times_s"].items()),
              flush=True)
        print(f"{what}: {len(seq['tree'])} files byte-equal in both modes, the HTML included; launches "
              f"{seq['launches']} in each, B1 on {checked['masked_moments']} and B2 on "
              f"{checked['binned_histograms']} inputs equal to their plain versions", flush=True)
        out[what] = {"sequential": {k: seq[k] for k in ("wall_s", "launches", "block_times_s", "schedule",
                                                         "peak_mib")},
                     "concurrent": {"wall_s": conc["wall_s"], "launches": conc_launches,
                                    "block_times_s": conc["block_times_s"], "schedule": conc["schedule"],
                                    "peak_mib": conc["peak_mib"]},
                     "files_equal": len(seq["tree"]), "kernel_calls_checked": checked}
    return out


def phase_chaos(torch, seed: int, root: str) -> dict:
    """Phase 15c: configs_full on CHAOS_ROWS rows in the concurrent mode
    with ``ANOVOS_TPU_CHAOS=hang@node:<CHAOS_NODE>:secs=600`` (every
    attempt) and ``ANOVOS_TPU_NODE_TIMEOUT=CHAOS_TIMEOUT``: the watchdog
    interrupts and escalates the node (x1.5), its re-execution hangs again,
    and it is abandoned and degraded within its escalated bound; every
    other node finishes, and the report leads with the Degraded Sections
    tab naming it.  (configs_basic's one fan-out node is its basic report,
    which writes the report itself, so a hang there leaves no report to
    name it.)"""
    from anovos_tpu_torch import workflow

    _, main_dir, si = full_inputs(seed + 15, os.path.join(root, "chaos"), CHAOS_ROWS)
    knobs = {"ANOVOS_TPU_CHAOS": f"hang@node:{CHAOS_NODE}:secs=600:n=99",
             "ANOVOS_TPU_NODE_TIMEOUT": str(CHAOS_TIMEOUT)}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        with executor("concurrent"):
            run = run_measured(torch, full_config(main_dir, si), os.path.join(root, "chaos", "run"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    summary = workflow.LAST_RUN_SUMMARY
    node = summary["nodes"][CHAOS_NODE]
    bound = CHAOS_TIMEOUT * (1 + 1.5)
    check(list(run["degraded"]) == [CHAOS_NODE], f"chaos: degraded {run['degraded']}")
    check(f"escalated bound ({CHAOS_TIMEOUT}s x1.5)" in run["degraded"][CHAOS_NODE], run["degraded"][CHAOS_NODE])
    check(node["state"] == "degraded" and node["escalated"] and node["attempts"] == 2,
          f"chaos: the node {node}")
    check(bound - 0.1 <= node["dur_s"] <= bound + 2.0, f"chaos: degraded after {node['dur_s']} s, bound {bound} s")
    # the escalated bound's expiry pays a forced health probe, which the
    # healthy card passes: no flip
    check(summary["resilience"]["timeout_escalations"] == 1 and summary["resilience"]["timeout_retries"] == 1
          and summary["resilience"]["failovers"] == 0, f"chaos: {summary['resilience']}")
    others = {n: v["state"] for n, v in summary["nodes"].items() if n != CHAOS_NODE}
    check(all(st == "done" for st in others.values()), f"chaos: other nodes {others}")
    rdir = os.path.join(root, "chaos", "run", "report_stats")
    check("IV_calculation.csv" not in os.listdir(rdir), "chaos: the degraded node's CSV was written")
    with open(os.path.join(rdir, "ml_anovos_report.html")) as f:
        html = f.read()
    first_tab = re.search(r"onclick='showTab\(0\)'>([^<]*)</button>", html)
    check(first_tab is not None and first_tab.group(1) == "Degraded Sections", "chaos: no Degraded Sections tab")
    check(f"<b>{CHAOS_NODE}</b>" in html and "1 analytics section(s) DEGRADED" in html,
          "chaos: the tab does not name the node")
    for name in PATH_KERNELS["chaos"]:
        check(run["launches"][name] > 0, f"chaos: kernel {name} was not launched")
    print_schedule("chaos", run)
    print(f"chaos: {CHAOS_NODE} hung, escalated at {CHAOS_TIMEOUT} s, degraded after {node['dur_s']:.2f} s "
          f"(bound {bound:.1f} s); the run finished in {run['wall_s']:.2f} s with {len(others)} nodes done; "
          f"the report's first tab names it; launches {run['launches']}", flush=True)
    shutil.rmtree(os.path.join(root, "chaos"), ignore_errors=True)
    return {"wall_s": run["wall_s"], "degraded_after_s": node["dur_s"], "bound_s": bound,
            "launches": run["launches"], "schedule": run["schedule"], "peak_mib": run["peak_mib"]}


def phase_executor(torch, seed: int, runner: dict, full_runner: dict, root: str) -> dict:
    """Phase 15: 15a, 15b and 15c."""
    t0 = time.perf_counter()
    out = {"recommender": phase_recommender(torch),
           "sequential": phase_sequential(torch, runner, full_runner, root),
           "chaos": phase_chaos(torch, seed, root)}
    out["phase_s"] = time.perf_counter() - t0
    print(f"executor: phase 15 in {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: the run record
# ---------------------------------------------------------------------------
def devprof_split(man: dict) -> dict:
    """{node: [wall, device, dispatch, transfer, host seconds, h2d bytes,
    d2h bytes]} of a manifest's devprof section."""
    keys = ("wall_s", "device_time_s", "dispatch_s", "transfer_s", "host_s", "h2d_bytes", "d2h_bytes")
    return {n: [e[k] for k in keys] for n, e in sorted((man.get("devprof") or {}).items())}


def check_devprof(man: dict, what: str) -> None:
    """Every node of the schedule has a devprof entry whose four parts sum
    to at most its wall."""
    nodes = set(man["scheduler"]["nodes"])
    dev = man.get("devprof") or {}
    check(set(dev) == nodes, f"{what}: devprof entries {sorted(dev)} for nodes {sorted(nodes)}")
    for n, e in dev.items():
        parts = e["device_time_s"] + e["dispatch_s"] + e["transfer_s"] + e["host_s"]
        check(parts <= e["wall_s"] + 1e-6, f"{what}: {n}'s parts {parts} exceed its wall {e['wall_s']}")


class LaunchNodes:
    """While in its ``with`` block: the scheduler node each kernel launch
    happens in (``obs.devprof.current_node`` at ``kernels.count_launch``)."""

    def __enter__(self):
        from anovos_tpu_torch.obs import devprof
        from anovos_tpu_torch.ops import kernels

        self.nodes = {name: set() for name in kernels.LAUNCHES}
        self.saved = kernels.count_launch
        count = kernels.count_launch

        def counted(name):
            self.nodes[name].add(devprof.current_node())
            count(name)

        kernels.count_launch = counted
        return self

    def __exit__(self, *exc):
        from anovos_tpu_torch.ops import kernels

        kernels.count_launch = self.saved


def traced_htod(path: str) -> tuple:
    """(bytes, copies) of the host-to-device copies in a torch.profiler
    Chrome trace (CUPTI's memcpy records, each with its ``bytes``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    check(all("bytes" in e.get("args", {}) for e in copies), "profiler trace: a memcpy without its bytes")
    return sum(int(e["args"]["bytes"]) for e in copies), len(copies)


def parquet_cells(path: str) -> int:
    """Rows x columns of the parquet files in the folder ``path``."""
    import pyarrow.parquet as pq

    metas = [pq.ParquetFile(os.path.join(path, f)).metadata for f in os.listdir(path) if f.endswith(".parquet")]
    return sum(m.num_rows * m.num_columns for m in metas)


def profiled_kernels(path: str, node_names) -> dict:
    """From a torch.profiler Chrome trace: per kernel of
    PROFILE_KERNEL_NAMES, the count of its device events and, for each, the
    node ranges (``record_function``) that contain it; how many of them the
    trace ties to a launch event by correlation id."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in node_names]
    launches = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    out = {}
    for kname, sym in PROFILE_KERNEL_NAMES.items():
        ks = [e for e in events if e.get("cat") == PROFILE_KERNEL_CAT and sym in e.get("name", "")]
        out[kname] = {
            "count": len(ks),
            "under": [sorted({n for n, t0, t1 in ranges if t0 - RANGE_SLACK_US <= float(k["ts"])
                              and float(k["ts"]) + float(k.get("dur", 0)) <= t1 + RANGE_SLACK_US})
                      for k in ks],
            "correlated": sum(1 for k in ks if k.get("args", {}).get("correlation") in launches)}
    out["node_ranges"] = len(ranges)
    return out


def drain_probe(torch) -> dict:
    """A scheduler node that leaves a known stretch of device work in
    flight (``torch.cuda._sleep`` of QUEUE_CYCLES on its stream, timed by
    CUDA events around it) and returns, in each mode under
    ``ANOVOS_TPU_DEVPROF=full``: the device time its drain books against
    that stretch."""
    from anovos_tpu_torch.obs import devprof
    from anovos_tpu_torch.parallel.scheduler import DagScheduler

    out = {}
    saved = os.environ.get("ANOVOS_TPU_DEVPROF")
    os.environ["ANOVOS_TPU_DEVPROF"] = "full"
    try:
        for mode in ("sequential", "concurrent"):
            events = []

            def body():
                stream = torch.cuda.current_stream()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record(stream)
                torch.cuda._sleep(QUEUE_CYCLES)
                b.record(stream)
                events.append((a, b))

            sched = DagScheduler(name="drain-probe")
            sched.add("in_flight", body, placement="device")
            devprof.reset()
            summary = sched.run(mode=mode, max_workers=1)
            a, b = events[0]
            b.synchronize()
            slept = a.elapsed_time(b) / 1e3
            r = devprof.results()["in_flight"]
            check(summary["nodes"]["in_flight"]["stream"] == (mode == "concurrent"),
                  f"drain probe ({mode}): stream {summary['nodes']['in_flight']['stream']}")
            check(0.8 * slept <= r["device_time_s"] <= r["wall_s"],
                  f"drain probe ({mode}): {slept * 1e3:.3f} ms in flight, device time booked {r}")
            out[mode] = {"in_flight_s": round(slept, 6), "device_time_s": r["device_time_s"],
                         "wall_s": r["wall_s"], "floor_s": round(devprof._PROBE_FLOOR, 9)}
    finally:
        os.environ.pop("ANOVOS_TPU_DEVPROF", None)
        if saved is not None:
            os.environ["ANOVOS_TPU_DEVPROF"] = saved
    return out


def phase_record(torch, runner: dict, seq_launches: dict, root: str) -> dict:
    """Phase 16: (a), (b) and (c) of the module docstring."""
    import pandas as pd

    from anovos_tpu_torch import obs, workflow
    from anovos_tpu_torch.data_report.report_generation import anovos_report
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.shared import runtime
    from anovos_tpu_torch.shared.runtime import get_runtime

    t_phase = time.perf_counter()
    out = {}
    # (a) phase 9's manifest
    man = obs.load_manifest(runner["manifest_path"])
    check(set(man["scheduler"]["nodes"]) == set(runner["schedule"]["deps"]),
          f"phase 9's manifest names {sorted(man['scheduler']['nodes'])}")
    check_devprof(man, "phase 9")
    check(man["block_seconds"] == runner["block_times_s"],
          f"phase 9: block_seconds {man['block_seconds']} vs block_times() {runner['block_times_s']}")
    check(man["backend"] == get_runtime().device.type and man["executor"]["mode"] == runner["schedule"]["mode"],
          f"phase 9's manifest: {man['backend']}, {man['executor']}")
    out["runner"] = {"wall_s": runner["wall_s"], "scheduler_wall_s": man["scheduler"]["wall_s"],
                     "scheduler_wall_before_s": RUNNER_WALL_BEFORE_S,
                     "scheduler_wall_before_rows": RUNNER_WALL_BEFORE_ROWS,
                     "mode": man["executor"]["mode"], "devprof": devprof_split(man)}
    print(f"record: phase 9 scheduler wall {man['scheduler']['wall_s']:.3f} s in the {man['executor']['mode']} "
          f"mode at {RUNNER_ROWS} rows (before the run record: {RUNNER_WALL_BEFORE_S} s at "
          f"{RUNNER_WALL_BEFORE_ROWS} rows), workflow.main {runner['wall_s']:.3f} s; "
          f"its manifest names all "
          f"{len(man['scheduler']['nodes'])} nodes; block_seconds equal block_times()", flush=True)
    print("record_phase9_devprof " + json.dumps(out["runner"]["devprof"]), flush=True)

    # (b) two sequential runs on RECORD_ROWS of phase 9's rows
    base = os.path.join(root, "record")
    sub_dir = os.path.join(base, "income")
    os.makedirs(sub_dir)
    pd.read_parquet(runner["main_dir"]).iloc[:RECORD_ROWS].to_parquet(
        os.path.join(sub_dir, "part-00000.parquet"), index=False)
    cfg = basic_config(sub_dir, runner["join_dir"])
    views, seq = [], []
    for i in (1, 2):
        with executor("sequential"):
            run = run_measured(torch, cfg, os.path.join(base, f"sequential_{i}"))
        m = obs.load_manifest(run["manifest_path"])
        check_devprof(m, f"sequential run {i}")
        views.append(obs.stable_view(m))
        seq.append({"wall_s": run["wall_s"], "devprof": devprof_split(m)})
        views_tree = run["tree"]
    check(views[0] == views[1], "the two sequential runs' stable_view differ: "
          + str(sorted(k for k in views[0] if views[0][k] != views[1].get(k))))
    out["sequential"] = seq
    print(f"record: two sequential runs on {RECORD_ROWS} rows ({seq[0]['wall_s']:.3f} s, "
          f"{seq[1]['wall_s']:.3f} s): stable_view equal", flush=True)
    print("record_sequential_devprof " + json.dumps(seq[1]["devprof"]), flush=True)

    # (c) workflow.run with the trace, devprof=full and the profiler
    run_dir, prof_dir = os.path.join(base, "traced"), os.path.join(base, "profile")
    os.makedirs(run_dir)
    cfg_path = os.path.join(base, "configs_basic.yaml")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    env = {"ANOVOS_TPU_TRACE": "1", "ANOVOS_TPU_DEVPROF": "full", "ANOVOS_PROFILE": prof_dir}
    saved = {k: os.environ.get(k) for k in env}
    cwd = os.getcwd()
    device = get_runtime().device
    kernels.reset_launches()
    os.environ.update(env)
    # as `python -m anovos_tpu_torch` starts: no runtime set, so the
    # profiler's wrapper takes the one main will use
    runtime._RUNTIME = None
    try:
        with executor(None), LaunchNodes() as seen:
            os.chdir(run_dir)
            t0 = time.perf_counter()
            workflow.run(cfg_path, "local")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["tree"] = tree_digest(run_dir)
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    out["launches"] = dict(kernels.LAUNCHES)
    check(runtime.peek_runtime() is not None and runtime.peek_runtime().device == device,
          f"the traced run's runtime {runtime.peek_runtime()}, {device} before it")
    check(out["tree"] == views_tree, "the traced run's files differ from the sequential runs': "
          + str(sorted(k for k in set(out["tree"]) | set(views_tree) if out["tree"].get(k) != views_tree.get(k))))
    man = obs.load_manifest(workflow.LAST_MANIFEST_PATH)
    nodes = set(man["scheduler"]["nodes"])
    check_devprof(man, "the traced run")
    with open(man["trace_path"]) as f:
        events = json.load(f)["traceEvents"]
    lanes = {}
    for e in events:
        if e.get("cat") == "node" and e["ph"] == "X" and e["name"] in nodes:
            lanes[e["tid"]] = lanes.get(e["tid"], 0.0) + e["dur"] / 1e6
    sched_wall = man["scheduler"]["wall_s"]
    check(lanes and max(lanes.values()) <= 1.10 * sched_wall + 0.05,
          f"node spans of a lane sum to {max(lanes.values(), default=0):.3f} s, scheduler wall {sched_wall} s")
    launching = {n for name in PROFILE_KERNEL_NAMES for n in seen.nodes[name]}
    check(None not in launching and launching,
          f"kernel launches outside any node: {seen.nodes}")
    (prof_path,) = [os.path.join(prof_dir, p) for p in os.listdir(prof_dir)]
    h2d = man["metrics"]["transfer_h2d_bytes_total"]["series"][""]
    htod, copies = traced_htod(prof_path)
    # the main input's cells and the join side's (its rows' ifa, age and workclass)
    least = 5 * (parquet_cells(sub_dir) + 3 * runner["side_rows"])
    check(least <= h2d <= htod, f"manifest h2d bytes {h2d}: the inputs need at least {least}, "
          f"the profiler trace copied {htod} in {copies} copies")
    prof = profiled_kernels(prof_path, nodes)
    for name in PROFILE_KERNEL_NAMES:
        p = prof[name]
        check(p["count"] == out["launches"][name] == seq_launches[name],
              f"profiler trace: {p['count']} {name} kernels, {out['launches'][name]} launched, "
              f"{seq_launches[name]} in phase 15b")
        check(all(set(u) & seen.nodes[name] for u in p["under"]),
              f"profiler trace: {name} kernels outside their launching node's range: {p['under']} "
              f"(launched in {sorted(map(str, seen.nodes[name]))})")
    html = anovos_report(master_path=os.path.dirname(os.path.dirname(workflow.LAST_MANIFEST_PATH)),
                         final_report_path=os.path.join(base, "rendered"))
    with open(html) as f:
        tabs = re.findall(r"onclick='showTab\(\d+\)'>([^<]*)</button>", f.read())
    check(tabs[-1:] == ["Run Timings"], f"the re-rendered report's tabs: {tabs}")
    out["traced"] = {"wall_s": wall, "mode": man["executor"]["mode"], "h2d_bytes": h2d,
                     "h2d_least_bytes": least, "htod_trace_bytes": htod, "htod_trace_copies": copies,
                     "lane_sums_s": sorted(round(v, 4) for v in lanes.values()), "scheduler_wall_s": sched_wall,
                     "launching_nodes": {k: sorted(map(str, v)) for k, v in seen.nodes.items() if v},
                     "profile": {k: ({kk: vv for kk, vv in v.items() if kk != "under"} if isinstance(v, dict) else v)
                                 for k, v in prof.items()},
                     "profile_mib": os.path.getsize(prof_path) / 2**20, "devprof": devprof_split(man)}
    print(f"record: traced run ({man['executor']['mode']}, devprof full, profiler on) {wall:.3f} s; lanes "
          f"{out['traced']['lane_sums_s']} s of node spans against a {sched_wall} s scheduler wall; B1/B2 "
          f"launched in {out['traced']['launching_nodes']} and in the profiler trace "
          f"({out['traced']['profile_mib']:.1f} MiB) {prof['masked_moments']['count']} and "
          f"{prof['binned_histograms']['count']} times under their nodes' ranges "
          f"({prof['masked_moments']['correlated'] + prof['binned_histograms']['correlated']} tied to a "
          f"launch by correlation id); h2d {h2d:.0f} B booked, at least {least} B of input, {htod} B in "
          f"{copies} copies in the profiler trace; the re-rendered report ends with Run Timings",
          flush=True)
    print("record_traced_devprof " + json.dumps(out["traced"]["devprof"]), flush=True)
    out["drain_probe"] = drain_probe(torch)
    print("record: drain probe " + ", ".join(
        f"{m}: {v['in_flight_s'] * 1e3:.3f} ms in flight, {v['device_time_s'] * 1e3:.3f} ms booked "
        f"(floor {v['floor_s'] * 1e6:.2f} us)" for m, v in out["drain_probe"].items()), flush=True)
    shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"record: phase 16 in {out['phase_s']:.1f} s", flush=True)
    return out


class env_knobs:
    """Environment variables set inside the block (a value of ``None``
    unsets one), restored after it."""

    def __init__(self, **knobs):
        self.knobs = knobs

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.knobs}
        for k, v in self.knobs.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


class LogLines(logging.Handler):
    """The messages a logger emits while in the ``with`` block."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.logger, self.lines = logging.getLogger(name), []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def held_to_plain(torch, given, launches: dict, what: str) -> dict:
    """Each B1 and B2 launch of a run, on the inputs the runner gave it,
    against its plain version: B1 twice with the same bits and within its
    allowance (the largest error as a share of it), B2 equal."""
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_plain

    for name, calls in given.seen.items():
        check(len(calls) == launches[name], f"{what}: {len(calls)} {name} calls recorded, {launches[name]} launches")
    share, err, shapes = 0.0, 0.0, []
    for Xc, Mc in given.seen["masked_moments"]:
        acc = check_moments_twice(torch, Xc, Mc, what).cpu().numpy()
        share = max([share, *moments_errors(acc, masked_moments_plain(Xc, Mc).cpu().numpy()).values()])
        shapes.append(list(Xc.shape))
    for Xc, Mc, cuts, nbins in given.seen["binned_histograms"]:
        got, plain = binned_histograms_cols(Xc, Mc, cuts, nbins), binned_histograms_plain(Xc, Mc, cuts, nbins)
        check(torch.equal(got, plain), f"{what}: binned_histograms differs from plain")
        err = max(err, float((got - plain).abs().max().item()))
        shapes.append(list(Xc.shape) + [nbins])
    return {"b1_share_of_allowance": share, "b2_max_abs_err": err, "shapes": shapes}


def phase_node_cache(torch, record: dict, runner: dict, root: str) -> dict:
    """Phase 17: (a)-(e) of the module docstring."""
    import copy

    import pandas as pd

    from anovos_tpu_torch import obs
    from anovos_tpu_torch.cache import CacheStore
    from anovos_tpu_torch.shared.runtime import get_runtime

    t_phase = time.perf_counter()
    base = os.path.join(root, "node_cache")
    sub_dir, store = os.path.join(base, "income"), os.path.join(base, "store")
    os.makedirs(sub_dir)
    pd.read_parquet(runner["main_dir"]).iloc[:RECORD_ROWS].to_parquet(
        os.path.join(sub_dir, "part-00000.parquet"), index=False)
    cfg = basic_config(sub_dir, runner["join_dir"])
    edited = copy.deepcopy(cfg)
    edited["anovos_basic_report"]["report_args"][CACHE_EDIT[0]] = CACHE_EDIT[1]
    out, path = {"rows": RECORD_ROWS}, {}

    def run(name, cfg, cache=store, given=None):
        """run_measured in the default mode with the cache at ``cache``:
        its wall, launches, schedule, tree, and the manifest's cache
        section and cached nodes."""
        with executor(None), env_knobs(ANOVOS_TPU_CACHE=cache):
            r = run_measured(torch, cfg, os.path.join(base, name))
        m = obs.load_manifest(r["manifest_path"])
        r["cache"], r["cached"] = m["cache"], {n: v["cached"] for n, v in m["scheduler"]["nodes"].items()}
        if cache is not None:
            for k, v in r["launches"].items():
                path[k] = path.get(k, 0) + v
        return r

    def launched(r, b1, b2, what):
        check(r["launches"]["masked_moments"] == b1 and r["launches"]["binned_histograms"] == b2,
              f"{what}: launches {r['launches']}, expected B1 {b1} and B2 {b2}")

    def same_tree(got, exp, what):
        check(got == exp, f"{what}: files differ: "
              + str(sorted(k for k in set(got) | set(exp) if got.get(k) != exp.get(k))[:10]))

    # (a) populate
    with KernelInputs(torch) as given:
        a = run("populate", cfg)
    launched(a, 2, 1, "(a) populate")
    out["populate_kernels"] = held_to_plain(torch, given, a["launches"], "(a) populate")
    del given
    check(a["cache"]["misses"] == 3 and a["cache"]["hits"] == 0, f"(a) populate: {a['cache']}")
    same_tree(a["tree"], record["tree"], "(a) populate against phase 16 (c)")
    # (b) full hit
    b = run("hit", cfg)
    check(b["cache"]["misses"] == 0 and b["cache"]["hits"] == 3 and all(b["cached"].values()),
          f"(b) full hit: {b['cache']}, cached {b['cached']}")
    launched(b, 0, 0, "(b) full hit")
    same_tree(b["tree"], a["tree"], "(b) full hit against (a)")
    # (c) incremental: the report alone re-executes, on the restored df
    with KernelInputs(torch) as given:
        c = run("incremental", edited)
    check(c["cached"] == {"join_dataset": True, "timeseries_analyzer/auto_detection": True,
                          "anovos_basic_report": False}, f"(c) incremental: cached {c['cached']}")
    launched(c, 2, 1, "(c) incremental")
    out["incremental_kernels"] = held_to_plain(torch, given, c["launches"], "(c) incremental")
    del given
    u = run("edited_uncached", edited, cache=None)
    check(u["cache"] is None, f"the uncached run's cache section {u['cache']}")
    same_tree(c["tree"], u["tree"], "(c) incremental against the uncached edited run")
    for name, r in (("populate", a), ("hit", b), ("incremental", c), ("edited_uncached", u)):
        out[name] = {"wall_s": r["wall_s"], "scheduler_wall_s": r["schedule"]["wall_s"],
                     "restore_s": (r["cache"] or {}).get("restore_s"), "launches": r["launches"],
                     "block_times_s": r["block_times_s"], "peak_mib": r["peak_mib"]}
    print(f"node_cache: (a) populate {a['wall_s']:.3f} s (scheduler {a['schedule']['wall_s']:.3f} s), "
          f"3 misses, B1 {a['launches']['masked_moments']} and B2 {a['launches']['binned_histograms']} "
          f"held to plain ({out['populate_kernels']}); its tree equals phase 16 (c)'s ({len(a['tree'])} files)",
          flush=True)
    print(f"node_cache: (b) full hit {b['wall_s']:.3f} s (scheduler {b['schedule']['wall_s']:.3f} s, restore "
          f"{b['cache']['restore_s']:.4f} s) beside (a)'s {a['wall_s']:.3f} s (scheduler "
          f"{a['schedule']['wall_s']:.3f} s); 3 hits, 0 launches, the tree equal", flush=True)
    print(f"node_cache: (c) incremental ({CACHE_EDIT[0]} = {CACHE_EDIT[1]!r}) {c['wall_s']:.3f} s (restore "
          f"{c['cache']['restore_s']:.4f} s), the report re-executed on the restored df, B1 and B2 held to "
          f"plain ({out['incremental_kernels']}); the tree equals the uncached edited run's "
          f"({u['wall_s']:.3f} s)", flush=True)

    # (d) a hard kill inside the report node, then --resume, in one directory
    kill_dir, cfg_path = os.path.join(base, "killed"), os.path.join(base, "configs_basic.json")
    os.makedirs(kill_dir)
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    kill = (f"import os; import anovos_tpu_torch.workflow as w; "
            f"w.anovos_basic_report = lambda *a, **k: os._exit({KILL_CODE}); ")
    run_cli = (CACHE_CLI_PRELUDE + f"import runpy, sys; sys.argv = ['anovos_tpu_torch', {cfg_path!r}, 'local', *sys.argv[1:]]; "
               "runpy.run_module('anovos_tpu_torch', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k not in ("ANOVOS_TPU_CACHE", "ANOVOS_TPU_EXECUTOR")}
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for code, argv, extra in ((kill + run_cli, [], {"ANOVOS_TPU_CACHE": ".anovos_cache",
                                                     "ANOVOS_TPU_EXECUTOR": "sequential"}),
                              (run_cli, ["--resume"], {})):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code, *argv], cwd=kill_dir, env={**env, **extra},
                             capture_output=True, text=True, timeout=CLI_TIMEOUT)
        procs.append((res, time.perf_counter() - t0))
    (killed, kill_s), (resumed, resume_s) = procs
    check(killed.returncode == KILL_CODE, f"(d) the killed process exited {killed.returncode}: "
          f"{killed.stderr[-2000:]}")
    check(resumed.returncode == 0, f"(d) the --resume process exited {resumed.returncode}: {resumed.stderr[-3000:]}")
    m = obs.load_manifest(os.path.join(kill_dir, "output", "obs", "run_manifest.json"))
    check(m["backend"] == get_runtime().device.type and m["cache"]["root"] == os.path.join(kill_dir, ".anovos_cache")
          and m["cache"]["resumed_from"] == 2 and (m["cache"]["hits"], m["cache"]["misses"]) == (2, 1)
          and "records 2 previously committed" in resumed.stderr, f"(d) --resume: {m['backend']}, {m['cache']}")
    same_tree(tree_digest(kill_dir, skip=("obs", ".anovos_cache")), a["tree"], "(d) resumed against (a)")
    out["kill_resume"] = {"killed_s": kill_s, "resume_s": resume_s, "cache": m["cache"],
                          "scheduler_wall_s": m["scheduler"]["wall_s"]}
    print(f"node_cache: (d) killed at the report node ({kill_s:.1f} s, exit {killed.returncode}), "
          f"--resume ({resume_s:.1f} s, {m['executor']['mode']}): resumed_from {m['cache']['resumed_from']}, "
          f"{m['cache']['hits']} hits, {m['cache']['misses']} miss, the tree equal to (a)'s", flush=True)

    # (e) the end-of-run sweep under a cap below the store's size
    before = CacheStore(store).total_bytes()
    with env_knobs(ANOVOS_TPU_CACHE_MAX_BYTES=str(before // 2)), LogLines("anovos_tpu_torch.workflow") as log:
        e = run("swept", cfg)
    after = CacheStore(store).total_bytes()
    swept = [line for line in log.lines if line.startswith("cache gc:")]
    check(e["cache"]["hits"] == 3 and after <= before // 2 and swept, f"(e) sweep: {before} -> {after} B, {swept}")
    out["sweep"] = {"before_bytes": before, "after_bytes": after, "log": swept}
    print(f"node_cache: (e) sweep to half the store: {before} -> {after} B; logged '{swept[0]}'", flush=True)
    out["launches"] = path
    shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"node_cache: phase 17 in {out['phase_s']:.1f} s; launches on the node_cache path {path}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: the live plane
# ---------------------------------------------------------------------------
class Scraper:
    """A thread that scrapes ``/metrics``, ``/healthz`` and ``/statusz`` of
    127.0.0.1:``port`` over one keep-alive connection every
    LIVE_SCRAPE_PERIOD_S seconds while its ``with`` block runs (a refused connection, before the
    listener is up or after it stopped, is retried): ``scrapes`` holds
    ``(t, path, status, body)``."""

    PATHS = ("/metrics", "/healthz", "/statusz")

    def __init__(self, port: int):
        import threading

        self.port, self.period, self.scrapes = port, LIVE_SCRAPE_PERIOD_S, []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.loop, name="chip-smoke-scraper")

    def loop(self):
        import http.client

        conn = None
        while not self.stop.is_set():
            for path in self.PATHS:
                try:
                    if conn is None:
                        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=10)
                    conn.request("GET", path)
                    r = conn.getresponse()
                    self.scrapes.append((time.perf_counter(), path, r.status, r.read().decode()))
                except (OSError, http.client.HTTPException):
                    if conn is not None:
                        conn.close()
                    conn = None
                    break
            self.stop.wait(self.period)
        if conn is not None:
            conn.close()

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=30)

    def bodies(self, path: str) -> list:
        return [(t, body) for t, p, code, body in self.scrapes if p == path and code in (200, 503)]


def prometheus_samples(body: str) -> tuple:
    """A /metrics body parsed as the Prometheus text format: ({series:
    value}, {family: type}); fails on a line that is neither a comment nor
    ``name[{labels}] value``."""
    samples, types = {}, {}
    for line in body.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
            continue
        if not line or line.startswith("# HELP "):
            continue
        m = re.fullmatch(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)', line)
        check(m is not None, f"live plane: /metrics line not in the Prometheus text format: {line!r}")
        samples[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return samples, types


def check_scrapes(sc: Scraper, what: str, given: KernelInputs, want_doctor: bool) -> dict:
    """(a)/(c): at least LIVE_MIN_SCRAPES of each endpoint; /metrics parses,
    its counters never go down from scrape to scrape, and it carries the
    card's memory gauges; /statusz shows a node on the card in flight in
    some scrape, on the cuda backend, with a ``doctor`` field when a
    previous manifest exists; B1 and B2 ran between the first and the last
    scrape."""
    counts = {p: len(sc.bodies(p)) for p in Scraper.PATHS}
    check(all(n >= LIVE_MIN_SCRAPES for n in counts.values()), f"{what}: scrapes {counts}")
    prev, mem = {}, False
    for _, body in sc.bodies("/metrics"):
        samples, types = prometheus_samples(body)
        for series, v in samples.items():
            if types.get(series.split("{")[0]) == "counter":
                check(v >= prev.get(series, v), f"{what}: counter {series} went down: {prev.get(series)} -> {v}")
                prev[series] = v
        mem = mem or any(k.startswith('device_bytes_in_use{device="cuda:0"}') for k in samples)
    check(mem, f"{what}: no /metrics scrape carried device_bytes_in_use of cuda:0")
    docs = [json.loads(b) for _, b in sc.bodies("/statusz")]
    on_card = [e["node"] for d in docs for e in d["inflight"] if e.get("lane") != "host"]
    check(bool(on_card), f"{what}: no /statusz scrape had a node on the card in flight")
    check(all(d["backend"] == "cuda" and d["rendezvous_holders"] == [] for d in docs),
          f"{what}: /statusz backend {sorted({d['backend'] for d in docs})}")
    doctors = [d["doctor"] for d in docs if d.get("doctor")]
    check(bool(doctors) == want_doctor, f"{what}: /statusz doctor fields {len(doctors)}, expected "
          f"{'some' if want_doctor else 'none'}")
    health = {json.loads(b)["status"] for _, b in sc.bodies("/healthz")}
    t0, t1 = sc.scrapes[0][0], sc.scrapes[-1][0]
    inside = {k: all(t0 <= t <= t1 for t in v) and len(v) for k, v in given.times.items()}
    check(all(inside.values()), f"{what}: kernel calls outside the scraped window {inside}")
    return {"scrapes": counts, "health": sorted(health), "inflight_on_card": sorted(set(on_card)),
            "doctor_slow": sorted({n for d in doctors for n in d.get("slow", [])})}


def segments_partition(obs_dir: str, tapped: list, left: list) -> dict:
    """The rotated segments against an uninterrupted export of the same
    spans: every span the tracer recorded (``tapped``, in record order)
    exported once, in one segment or still in the ring (``left``, spans
    after the final flush); the segments' union equal to the export of
    ``tapped`` less ``left``, event for event."""
    from anovos_tpu_torch.obs import get_tracer

    segs = sorted(f for f in os.listdir(obs_dir) if re.fullmatch(r"trace_\d{4}\.json", f))
    check(len(segs) >= LIVE_MIN_SEGMENTS, f"live plane: {len(segs)} trace segments, expected at least "
          f"{LIVE_MIN_SEGMENTS}")
    check(not os.path.exists(os.path.join(obs_dir, "trace.json")), "live plane: trace.json written beside "
          "the segments")
    key = lambda e: (e["ts"], e["tid"], e["name"], e.get("dur"))  # noqa: E731
    union = []
    for f in segs:
        with open(os.path.join(obs_dir, f)) as fh:
            union += [e for e in json.load(fh)["traceEvents"] if e["ph"] != "M"]
    left_ids = {id(sp) for sp in left}
    whole = [e for e in get_tracer().to_chrome([sp for sp in tapped if id(sp) not in left_ids])["traceEvents"]
             if e["ph"] != "M"]
    check(sorted(union, key=key) == sorted(whole, key=key),
          f"live plane: the {len(segs)} segments hold {len(union)} events, the uninterrupted export "
          f"{len(whole)}")
    node_left = [sp.name for sp in left if sp.cat == "node"]
    check(not node_left, f"live plane: node spans after the final flush {node_left}")
    return {"segments": len(segs), "events": len(union), "after_flush": len(left)}


def check_overflowed_block(torch) -> dict:
    """Queue C3 on the card: B1 against its plain version on the (1, 6,000)
    block of N(0, 1)·1e20 with rows 2,000 onward null: n, min, max and
    nonzero equal, the mean within 1e-5, M2 +inf and M3 NaN in both, M4
    non-finite in both (the kernel's step merges carry M3's NaN into it),
    and the finalized variance, stddev, skewness and kurtosis of the same
    class: inf, inf, NaN, NaN."""
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain
    from anovos_tpu_torch.ops.reductions import finalize_moments

    g = np.random.default_rng(0)
    v = (g.standard_normal(6000) * 1e20).astype(np.float32)
    m = np.arange(6000) < 2000
    v[~m] = 0.0
    Xc, Mc = torch.from_numpy(v[None].copy()).cuda(), torch.from_numpy(m[None].copy()).cuda()
    got = check_moments_twice(torch, Xc, Mc, "the overflowed block").cpu().numpy()
    exp = masked_moments_plain(Xc, Mc).cpu().numpy()
    for row, name in ((0, "n"), (5, "min"), (6, "max"), (7, "nonzero")):
        check(np.array_equal(got[row], exp[row]), f"C3 block: {name} {got[row]} != plain {exp[row]}")
    check(np.allclose(got[1], exp[1], rtol=1e-5, atol=0.0), f"C3 block: mean {got[1]} != plain {exp[1]}")
    check(np.isposinf(got[2]).all() and np.isposinf(exp[2]).all(), f"C3 block: M2 {got[2]}, plain {exp[2]}")
    check(np.isnan(got[3]).all() and np.isnan(exp[3]).all(), f"C3 block: M3 {got[3]}, plain {exp[3]}")
    check(not np.isfinite(got[4]).any() and not np.isfinite(exp[4]).any(), f"C3 block: M4 {got[4]}, plain {exp[4]}")
    fin = [finalize_moments(*torch.from_numpy(a)) for a in (got, exp)]
    classes = {}
    for k in ("variance", "stddev", "skewness", "kurtosis"):
        a, b = fin[0][k].numpy(), fin[1][k].numpy()
        check(np.array_equal(a, b, equal_nan=True), f"C3 block: {k} {a} != plain {b}")
        classes[k] = str(a[0])
    check(classes == {"variance": "inf", "stddev": "inf", "skewness": "nan", "kurtosis": "nan"},
          f"C3 block: finalized {classes}")
    print(f"live_plane: the C3 block (1 x 6,000, rows 2,000 on null, N(0, 1)·1e20): B1 "
          f"[n, M2, M3, M4] {got[[0, 2, 3, 4], 0].tolist()}, plain {exp[[0, 2, 3, 4], 0].tolist()}; "
          f"finalized {classes} on both", flush=True)
    return {"kernel": {"n": float(got[0, 0]), "M2": str(got[2, 0]), "M3": str(got[3, 0]), "M4": str(got[4, 0])},
            "plain": {"n": float(exp[0, 0]), "M2": str(exp[2, 0]), "M3": str(exp[3, 0]), "M4": str(exp[4, 0])},
            "finalized": classes}


def phase_live_plane(torch, record: dict, runner: dict, root: str) -> dict:
    """Phase 18: (a)-(c) of the module docstring."""
    import copy
    import socket

    import pandas as pd

    from anovos_tpu_torch import obs, workflow
    from anovos_tpu_torch.obs import get_tracer, telemetry
    from anovos_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    out = {"rows": RECORD_ROWS, "c3_block": check_overflowed_block(torch)}
    base = os.path.join(root, "live_plane")
    sub_dir = os.path.join(base, "income")
    os.makedirs(sub_dir)
    pd.read_parquet(runner["main_dir"]).iloc[:RECORD_ROWS].to_parquet(
        os.path.join(sub_dir, "part-00000.parquet"), index=False)
    cfg = basic_config(sub_dir, runner["join_dir"])
    path = {}

    def free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def live_run(run_dir: str, what: str, want_doctor: bool, **extra) -> dict:
        """configs_basic through workflow.main in ``run_dir`` (kept if it
        exists) in the default mode, with the plane on a free port, trace
        rotation, the flight recorder and ANOVOS_TPU_DEVPROF=full, scraped
        the whole time, every span the tracer records tapped."""
        port = free_port()
        os.makedirs(run_dir, exist_ok=True)
        tracer, tapped = get_tracer(), []
        record_span = tracer._record

        def tap(sp):
            tapped.append(sp)
            record_span(sp)

        before = dict(kernels.LAUNCHES)
        cwd = os.getcwd()
        knobs = dict(ANOVOS_TPU_TELEMETRY=str(port), ANOVOS_TPU_TRACE_ROTATE=LIVE_ROTATE,
                     ANOVOS_TPU_FLIGHTREC="256", ANOVOS_TPU_TRACE="1", ANOVOS_TPU_DEVPROF="full", **extra)
        tracer._record = tap
        try:
            with executor(None), env_knobs(**knobs), KernelInputs(torch) as given, Scraper(port) as sc:
                os.chdir(run_dir)
                t0 = time.perf_counter()
                err = None
                try:
                    workflow.main(copy.deepcopy(cfg), "local")
                except Exception as e:  # (b)'s run ends in its NodeTimeout
                    err = e
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            del tracer._record
        check(telemetry.current() is None, f"{what}: the listener outlived the run")
        launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v
        left = tracer.snapshot()
        return {"wall_s": wall, "sc": sc, "given": given, "launches": launches, "err": err,
                "tapped": tapped, "left": left, "tree": tree_digest(run_dir),
                "obs_dir": os.path.join(run_dir, "output", "obs"), "what": what, "want_doctor": want_doctor}

    def launched(r, b1, b2):
        check((r["launches"]["masked_moments"], r["launches"]["binned_histograms"]) == (b1, b2),
              f"{r['what']}: launches {r['launches']}, expected B1 {b1} and B2 {b2}")

    # (a) a scraped run
    run_dir = os.path.join(base, "scraped")
    a = live_run(run_dir, "(a) scraped run", want_doctor=False)
    check(a["err"] is None, f"(a) scraped run failed: {a['err']!r}")
    launched(a, 2, 1)
    out["a"] = {"wall_s": a["wall_s"], "launches": a["launches"],
                "scraped": check_scrapes(a["sc"], "(a) scraped run", a["given"], False),
                "kernels": held_to_plain(torch, a["given"], a["launches"], "(a) scraped run"),
                "trace": segments_partition(a["obs_dir"], a["tapped"], a["left"])}
    check(a["tree"] == record["tree"], "(a) scraped run: files differ from phase 16 (c)'s: " + str(
        sorted(k for k in set(a["tree"]) | set(record["tree"]) if a["tree"].get(k) != record["tree"].get(k))[:10]))
    man_a = obs.load_manifest(os.path.join(a["obs_dir"], "run_manifest.json"))
    check(man_a["resilience"]["flight_dumps"] == [], f"(a): flight dumps {man_a['resilience']['flight_dumps']}")
    print(f"live_plane: (a) scraped run {a['wall_s']:.3f} s: {out['a']['scraped']['scrapes']} scrapes, "
          f"health {out['a']['scraped']['health']}, in flight on the card {out['a']['scraped']['inflight_on_card']}; "
          f"B1 {a['launches']['masked_moments']} and B2 {a['launches']['binned_histograms']} inside the scraped "
          f"window, held to plain ({out['a']['kernels']}); {out['a']['trace']['segments']} trace segments = the "
          f"uninterrupted export ({out['a']['trace']['events']} events); the tree equals phase 16 (c)'s",
          flush=True)
    baseline = os.path.join(base, "baseline_manifest.json")
    shutil.copy(os.path.join(a["obs_dir"], "run_manifest.json"), baseline)

    # (b) a chaos hang on the basic report under a node_timeout
    b = live_run(os.path.join(base, "hang"), "(b) hang", want_doctor=False,
                 ANOVOS_TPU_CHAOS=f"hang@node:{LIVE_HANG_NODE}:secs=600:n=99",
                 ANOVOS_TPU_NODE_TIMEOUT=str(LIVE_HANG_TIMEOUT))
    check(b["err"] is None, f"(b) hang: the run failed: {b['err']!r}")
    dumps = sorted(f for f in os.listdir(b["obs_dir"]) if f.startswith("flightrec_"))
    stem = "flightrec_" + re.sub(r"[^A-Za-z0-9._-]", "_", LIVE_HANG_NODE)
    check(dumps == [stem + ".json", stem + "_2.json"], f"(b) hang: dumps {dumps}")
    docs = []
    for f in dumps:
        with open(os.path.join(b["obs_dir"], f)) as fh:
            docs.append(json.load(fh))
    check([d["trigger"] for d in docs] == ["timeout_escalation", "node_abandoned"],
          f"(b) hang: triggers {[d['trigger'] for d in docs]}")
    check(LIVE_HANG_NODE in [e["node"] for e in docs[0]["inflight"]] and docs[0]["backend"] == "cuda"
          and "cuda:0" in docs[0]["hbm"], f"(b) hang: the escalation dump's in-flight set {docs[0]['inflight']}")
    man_b = obs.load_manifest(os.path.join(b["obs_dir"], "run_manifest.json"))
    check(man_b["resilience"]["flight_dumps"] == dumps and LIVE_HANG_NODE in man_b["resilience"]["degraded_sections"],
          f"(b) hang: manifest {man_b['resilience']['flight_dumps']}, {man_b['resilience']['degraded_sections']}")
    out["b"] = {"wall_s": b["wall_s"], "dumps": dumps, "launches": b["launches"],
                "escalated_after_s": [e.get("devprof", {}).get("elapsed_s") for e in docs[0]["inflight"]
                                      if e["node"] == LIVE_HANG_NODE][0]}
    print(f"live_plane: (b) hang on {LIVE_HANG_NODE} under a {LIVE_HANG_TIMEOUT} s node_timeout: "
          f"{b['wall_s']:.3f} s, dumps {dumps} (triggers timeout_escalation, the node in flight for "
          f"{out['b']['escalated_after_s']} s, then node_abandoned), the section degraded", flush=True)

    # (c) a second run in (a)'s directory, the report slowed by a device
    # sleep, then the perf doctor's diagnosis of the pair
    slowed, real = workflow.anovos_basic_report, workflow.anovos_basic_report

    def sleepy(*args, **kwargs):
        for _ in range(LIVE_SLEEP_CHUNKS):
            torch.cuda._sleep(QUEUE_CYCLES)
        return real(*args, **kwargs)

    workflow.anovos_basic_report = sleepy
    try:
        c = live_run(run_dir, "(c) slowed run", want_doctor=True)
    finally:
        workflow.anovos_basic_report = slowed
    check(c["err"] is None, f"(c) slowed run failed: {c['err']!r}")
    launched(c, 2, 1)
    out["c"] = {"wall_s": c["wall_s"], "launches": c["launches"],
                "scraped": check_scrapes(c["sc"], "(c) slowed run", c["given"], True),
                "kernels": held_to_plain(torch, c["given"], c["launches"], "(c) slowed run")}
    check(c["tree"] == record["tree"], "(c) slowed run: files differ from phase 16 (c)'s")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "anovos_tpu_torch.obs.diffing", "--json", "--baseline", baseline,
                          "--candidate", c["obs_dir"]], capture_output=True, text=True, timeout=CLI_TIMEOUT,
                         env={**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
    doctor_s = time.perf_counter() - t0
    check(res.returncode == 0, f"(c) perf doctor exited {res.returncode}: {res.stderr[-2000:]}")
    from anovos_tpu_torch.obs.diffing import validate_diagnosis

    diag = json.loads(res.stdout.strip().splitlines()[-1])
    errs = validate_diagnosis(diag)
    check(errs == [], f"(c) diagnosis schema: {errs}")
    top = diag["attributions"][0]
    deltas = {n: v["wall_delta_s"] for n, v in diag["nodes"].items() if v["wall_delta_s"] is not None}
    check(top["kind"] == "phase" and top["detail"].split("top movers: ")[1].startswith(LIVE_HANG_NODE + " ")
          and max(deltas, key=deltas.get) == LIVE_HANG_NODE, f"(c) diagnosis: top {top}, node deltas {deltas}")
    out["c"]["diagnosis"] = {"top": top, "node_wall_delta_s": deltas, "doctor_s": doctor_s,
                             "attributions": len(diag["attributions"])}
    print(f"live_plane: (c) slowed run in (a)'s directory {c['wall_s']:.3f} s ({LIVE_SLEEP_CHUNKS} device sleeps "
          f"of {QUEUE_CYCLES} cycles in {LIVE_HANG_NODE}); /statusz doctor slow {out['c']['scraped']['doctor_slow']}; "
          f"python -m anovos_tpu_torch.obs.diffing in {doctor_s:.2f} s ranks first: #{top['rank']} "
          f"[{top['kind']}:{top['subject']}] {top['detail']}", flush=True)
    out["launches"] = path
    shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"live_plane: phase 18 in {out['phase_s']:.1f} s; launches on the live-plane path {path}", flush=True)
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def serving_leftovers() -> list:
    """What a closed server must not leave in the process: serving threads,
    the live plane's listener, the serving provider, the flight recorder's
    arming."""
    import threading

    from anovos_tpu_torch.obs import flight, telemetry

    left = sorted(t.name for t in threading.enumerate() if t.name.startswith(SERVE_THREAD_PREFIX))
    if telemetry.current() is not None:
        left.append("telemetry listener")
    if "serving" in telemetry._providers():
        left.append("serving provider")
    if flight.enabled():
        left.append("flight recorder armed")
    return left


def apply_split(torch, program, frame, reps: int = 5) -> dict:
    """Where one apply of ``frame`` spends its wall: the upload
    (``Table.from_pandas``), each stage of the chain, the download
    (``to_pandas``), each ending in a device sync; the median of ``reps``
    applies, in ms."""
    from anovos_tpu_torch.shared.table import Table

    walls: dict = {}

    def lap(key, t0):
        torch.cuda.synchronize()
        walls.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)

    for _ in range(reps):
        t0 = time.perf_counter()
        t = Table.from_pandas(frame)
        lap("from_pandas", t0)
        for i, ft in enumerate(program.transformers):
            t0 = time.perf_counter()
            t = ft.apply(t)
            lap(f"{i}:{ft.family}", t0)
        t0 = time.perf_counter()
        t.to_pandas()
        lap("to_pandas", t0)
    return {k: round(float(np.median(v)), 3) for k, v in walls.items()}


def phase_serving(torch, seed: int) -> dict:
    """Phase 19: (a)-(f) of the module docstring."""
    import contextlib
    import io

    import pandas as pd

    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.obs import flight, telemetry
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.resilience.policy import reset_degraded
    from anovos_tpu_torch.serving import (ApplyProgram, FeatureServer, coerce_payload, fit_bundle,
                                          frame_to_payload, load_bundle, save_bundle)
    from anovos_tpu_torch.serving.__main__ import drive, main as serving_main, smoke_payloads
    from anovos_tpu_torch.serving.demo import DEMO_CHAIN, demo_frame, run_serve_fault
    from anovos_tpu_torch.shared.runtime import get_runtime
    from anovos_tpu_torch.shared.table import Table

    t_phase = time.perf_counter()
    # the runner's runs of phases 9-18 leave the flight recorder armed on
    # their obs dir, since removed, and their degraded sections, quarantined
    # parts and heartbeats in the registries /healthz folds: the servers
    # below arm their own recorder, and the serve-fault gates read /healthz
    flight.reset()
    reset_degraded()
    guard.reset()
    telemetry.clear_heartbeat()
    check(serving_leftovers() == [], f"serving: the process holds {serving_leftovers()} before the phase")
    tmp = tempfile.mkdtemp(prefix="anovos_serving_")
    out = {"fit_rows": SERVE_FIT_ROWS, "max_batch": SERVE_MAX_BATCH, "window_ms": SERVE_WINDOW_MS}
    launches = {}
    try:
        # (a) fit on the card, export, read back
        t0 = time.perf_counter()
        df = demo_frame(SERVE_FIT_ROWS, seed=7)
        table = Table.from_pandas(df)
        check(on_card([table]), "serving: the fit's Table is not on the card")
        setup_s = time.perf_counter() - t0
        kernels.reset_launches()
        with KernelInputs(torch) as given:
            t0 = time.perf_counter()
            bundle = fit_bundle(table, DEMO_CHAIN, source="chip_smoke")
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        launches["serving_export"] = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        cache = os.path.join(tmp, "cache")
        version = save_bundle(bundle, cache)
        loaded = load_bundle(cache, version)
        export_s = time.perf_counter() - t0
        check(loaded.doc == bundle.doc and [s["family"] for s in loaded.chain] == [n for n, _ in DEMO_CHAIN],
              "serving: the bundle read back differs from the one exported")
        check(loaded.doc["schema"]["fit_rows"] == SERVE_FIT_ROWS, "serving: fit_rows")
        for name in PATH_KERNELS["serving_export"]:
            check(launches["serving_export"][name] > 0, f"kernel {name} was not launched by the serving fit")
        held = held_to_plain(torch, given, launches["serving_export"], "serving fit")
        Xc, Mc = given.seen["masked_moments"][0]
        b1 = b1_row(torch, Xc, Mc, "serving_export", "the first fit's block")
        del given, table, df
        out["a"] = {"setup_s": setup_s, "fit_s": fit_s, "export_read_s": export_s, "version": version,
                    "launches": launches["serving_export"], "held": held}
        print(f"serving: (a) DEMO_CHAIN fitted on {SERVE_FIT_ROWS:,} rows in {fit_s:.3f} s (frame and "
              f"upload {setup_s:.3f} s), exported and read back in {export_s:.3f} s, bundle {version[:12]}; "
              f"launches {launches['serving_export']}, each held to plain ({held})", flush=True)

        # (b) boot and warm
        kernels.reset_launches()
        program = ApplyProgram(loaded)
        server = FeatureServer(program, window_ms=SERVE_WINDOW_MS, max_batch=SERVE_MAX_BATCH,
                               obs_dir=os.path.join(tmp, "server"))
        server.start(warm=True)
        try:
            launches["serving_warm"] = dict(kernels.LAUNCHES)
            warm = program.warm_stats
            check(warm["buckets"] == [8, 16, 32, 64, 128, 256], f"serving: buckets {warm['buckets']}")
            out["b"] = {"cold_start_s": server.cold_start_s, "warm": warm}
            print(f"serving: (b) cold start {server.cold_start_s:.3f} s (warm-up {warm['warm_wall_s']:.3f} s): "
                  f"bucket walls {warm['wall_s_per_bucket']}, launches {warm['launches_per_bucket']}, new "
                  f"allocator segments {warm['segments_per_bucket']}", flush=True)

            # (c) the load, then every response against its own batch apply
            src = demo_frame(SERVE_SRC_ROWS, seed=11)[loaded.input_names]
            payloads = smoke_payloads(src, SERVE_CLIENTS * SERVE_REQUESTS)
            kernels.reset_launches()
            mark = program.device_counters()
            wall, results = drive(server, payloads, SERVE_CLIENTS)
            after = program.device_counters()
            launches["serving_load"] = dict(kernels.LAUNCHES)
            stats = server.stats()
            check(after == mark and not any(launches["serving_load"].values()),
                  f"serving: after the warm-up the load launched {launches['serving_load']} and added "
                  f"{after[1] - mark[1]} allocator segment(s)")
            t0 = time.perf_counter()
            frames = []
            for i, (p, resp) in enumerate(zip(payloads, results)):
                check(resp is not None and "error" not in resp, f"serving: request {i} failed: {resp}")
                frame, err = coerce_payload(program.input_columns, p, SERVE_MAX_BATCH)
                check(err is None, f"serving: request {i} does not coerce: {err}")
                frames.append(frame)
                if i % SERVE_OWN_EVERY == 0:
                    check(resp["columns"] == frame_to_payload(program.apply_frame(frame)),
                          f"serving: response {i} differs from the batch apply of its own rows")
            whole = program.apply_frame(pd.concat(frames, ignore_index=True))
            offset = 0
            for i, (frame, resp) in enumerate(zip(frames, results)):
                part = whole.iloc[offset:offset + len(frame)].reset_index(drop=True)
                offset += len(frame)
                check(resp["columns"] == frame_to_payload(part),
                      f"serving: response {i} differs from the batch apply of the load's rows")
            parity_s = time.perf_counter() - t0
            split = apply_split(torch, program, program.pad_frame(frames[4], SERVE_MAX_BATCH))
            qps = len(payloads) / wall
            out["c"] = {"requests": len(payloads), "clients": SERVE_CLIENTS, "wall_s": wall, "qps": qps,
                        "rows": offset, "own_apply_checked": len(range(0, len(payloads), SERVE_OWN_EVERY)),
                        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"], "parity_s": parity_s,
                        "segments_after_parity": program.device_counters()[1] - mark[1],
                        "apply_split_ms": split}
            print(f"serving: (c) {len(payloads)} requests from {SERVE_CLIENTS} clients in {wall:.3f} s: "
                  f"{qps:.1f} QPS, p50 {stats['p50_ms']} ms, p99 {stats['p99_ms']} ms; every response equal "
                  f"to the batch apply of the load's {offset:,} rows, every {SERVE_OWN_EVERY}th to the apply of "
                  f"its own (checked in {parity_s:.2f} s); no launch and no new allocator segment after the "
                  f"warm-up", flush=True)
            print(f"serving: (c) one {SERVE_MAX_BATCH}-row apply, median of 5, ms: {split} (sum "
                  f"{sum(split.values()):.3f})", flush=True)

            # (d) hostile payloads, then a correct answer
            cols = payloads[1]["columns"]
            two = {k: v[:2] for k, v in cols.items()}
            hostile = [
                ("hostile_values", {"columns": {**two, "age": [float("inf"), 1.0]}}),
                ("hostile_values", {"columns": {**two, "age": [1e39, None]}}),
                ("schema_drift", {"columns": {**two, "bogus": [1.0, 2.0]}}),
                ("schema_drift", {"columns": {k: v for k, v in two.items() if k != "age"}}),
                ("wrong_dtype", {"columns": {**two, "age": ["nope", 1.0]}}),
                ("wrong_dtype", {"columns": {**two, "workclass": [1.0, 2.0]}}),
                ("bad_shape", {"columns": {**two, "age": [1.0]}}),
                ("bad_shape", {"columns": frame_to_payload(pd.concat([src.iloc[:SERVE_MAX_BATCH]] * 2,
                                                                     ignore_index=True))}),
                ("bad_request", {"rows": [1, 2]}),
            ]
            q0 = server.stats()["quarantined"]
            for code, payload in hostile:
                resp = server.serve(payload)
                check("error" in resp and resp["error"]["code"] == code, f"serving: hostile {code}: {resp}")
            ok = {"columns": two}
            resp = server.serve(ok)
            frame, _ = coerce_payload(program.input_columns, ok, SERVE_MAX_BATCH)
            check("error" not in resp and resp["columns"] == frame_to_payload(program.apply_frame(frame)),
                  "serving: a request after the hostile ones differs from its batch apply")
            check(server.stats()["quarantined"] - q0 == len(hostile), "serving: quarantine count")
            out["d"] = {"refused": len(hostile), "codes": sorted({c for c, _ in hostile})}
            print(f"serving: (d) {len(hostile)} hostile payloads refused with codes {out['d']['codes']}; "
                  f"the next request served equal to its batch apply", flush=True)
        finally:
            server.close()
        check(serving_leftovers() == [], f"serving: the closed server left {serving_leftovers()}")

        # (e) the serve-fault scenario
        kernels.reset_launches()
        t0 = time.perf_counter()
        rec = run_serve_fault(os.path.join(tmp, "serve_fault"))
        fault_s = time.perf_counter() - t0
        check(rec["ok"], f"serving: serve-fault: {rec.get('error')}")
        check(serving_leftovers() == [], f"serving: the serve-fault scenario left {serving_leftovers()}")
        out["e"] = {k: rec[k] for k in ("gates", "injections", "clean_p99_ms", "chaos_p99_ms", "quarantined",
                                        "served_after_fatal", "flightrec", "chaos_healthz_reasons")}
        out["e"].update({"wall_s": fault_s, "launches": dict(kernels.LAUNCHES)})
        print(f"serving: (e) serve-fault in {fault_s:.2f} s: every gate passed {sorted(rec['gates'])}; "
              f"p99 clean {rec['clean_p99_ms']} ms, chaos {rec['chaos_p99_ms']} ms (bound "
              f"{rec['p99_bound_ms']:.0f}); dumps {[d['file'] for d in rec['flightrec']]}", flush=True)

        # (f) the CLI in-process
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serving_main([*SERVE_SMOKE_ARGS, "--workdir", os.path.join(tmp, "cli")])
        cli_s = time.perf_counter() - t0
        smoke = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0 and smoke["serve_parity_ok"] and smoke["serve_errors"] == 0
              and smoke["backend"] == get_runtime().device.type, f"serving: smoke CLI rc {rc}: {smoke}")
        check(smoke["scrape_failures"] == 0 and smoke["healthz_status"] == "ok"
              and smoke["serve_errors_with_telemetry"] == 0, f"serving: smoke --telemetry: {smoke}")
        check(serving_leftovers() == [], f"serving: the smoke CLI left {serving_leftovers()}")
        out["f"] = {"wall_s": cli_s, **{k: smoke[k] for k in (
            "serve_qps", "serve_p50_ms", "serve_p99_ms", "serve_cold_start_s", "serve_requests",
            "telemetry_overhead_pct", "scrape_p50_ms", "scrape_p99_ms", "scrape_count")}}
        print(f"serving: (f) python -m anovos_tpu_torch.serving {' '.join(SERVE_SMOKE_ARGS)} in-process in "
              f"{cli_s:.2f} s: {json.dumps(out['f'])}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["kernels"] = {"masked_moments": [b1]}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serving: {card_line()}: {out['c']['qps']:.1f} QPS, p50 {out['c']['p50_ms']} ms, p99 "
          f"{out['c']['p99_ms']} ms, cold start {out['b']['cold_start_s']:.3f} s, bucket walls "
          f"{out['b']['warm']['wall_s_per_bucket']}; launches {launches}; phase 19 in {out['phase_s']:.1f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 20: the backend failover
# ---------------------------------------------------------------------------
class NodeLaunches:
    """While in its ``with`` block: every kernel launch as (kernel, the
    scheduler node it happens in, the runtime generation it happens at),
    read at ``kernels.count_launch``."""

    def __enter__(self):
        from anovos_tpu_torch.obs import devprof
        from anovos_tpu_torch.ops import kernels
        from anovos_tpu_torch.shared.runtime import runtime_generation

        self.calls, self.saved = [], kernels.count_launch
        count = kernels.count_launch

        def counted(name):
            self.calls.append((name, devprof.current_node(), runtime_generation()))
            count(name)

        kernels.count_launch = counted
        return self

    def __exit__(self, *exc):
        from anovos_tpu_torch.ops import kernels

        kernels.count_launch = self.saved

    def by_node(self) -> dict:
        """{kernel: {node: launches}}."""
        out: dict = {}
        for name, node, _ in self.calls:
            out.setdefault(name, {})
            out[name][node] = out[name].get(node, 0) + 1
        return out


def failover_probe(torch) -> dict:
    """Phase 20 (a): the health probe on the live card, healthy and under
    a worker stream's device sleep longer than its deadline; an ordinary
    error pays no probe, a CUDA-shaped one pays one and flips nothing."""
    from anovos_tpu_torch.resilience import failover
    from anovos_tpu_torch.shared.runtime import get_runtime

    walls = []
    for _ in range(FAILOVER_PROBES):
        t0 = time.perf_counter()
        ok = failover.backend_healthy()
        walls.append(time.perf_counter() - t0)
        check(ok, "failover: the probe calls the live card unhealthy")
    check(max(walls) < FAILOVER_DEFAULT_DEADLINE_S, f"failover: probe round trips {walls}")
    # the card's sleep rate, then a worker stream busy past the deadline
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(QUEUE_CYCLES)
    b.record()
    b.synchronize()
    cycles_per_s = QUEUE_CYCLES / (a.elapsed_time(b) / 1e3)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(int(cycles_per_s * FAILOVER_BUSY_S))
    t0 = time.perf_counter()
    ok = failover.backend_healthy(timeout_s=FAILOVER_DEADLINE_S)
    busy = time.perf_counter() - t0
    still_busy = not stream.query()
    stream.synchronize()
    check(ok and busy < FAILOVER_DEADLINE_S and still_busy,
          f"failover: probe under a {FAILOVER_BUSY_S} s device sleep: healthy {ok} in {busy:.4f} s "
          f"(deadline {FAILOVER_DEADLINE_S} s), the sleep still running {still_busy}")
    probes, real = [], failover.probe_in_process
    failover.probe_in_process = lambda *args, **kw: (probes.append(1), real(*args, **kw))[1]
    try:
        ordinary = failover.maybe_failover(ValueError("plain config error"))
        check(ordinary is False and probes == [], f"failover: an ordinary error paid {len(probes)} probe(s)")
        shaped = failover.maybe_failover(RuntimeError("CUDA error: an illegal memory access was encountered"))
        check(shaped is False and probes == [1], f"failover: a CUDA-shaped error on a healthy card: flipped "
              f"{shaped}, {len(probes)} probe(s)")
    finally:
        failover.probe_in_process = real
    check(failover.failover_count() == 0 and get_runtime().device.type == "cuda",
          f"failover: probes flipped the runtime to {get_runtime().device}")
    out = {"probe_ms": {"min": min(walls) * 1e3, "median": float(np.median(walls)) * 1e3, "max": max(walls) * 1e3},
           "busy_probe_ms": busy * 1e3, "busy_sleep_s": FAILOVER_BUSY_S, "deadline_s": FAILOVER_DEADLINE_S}
    print(f"failover: (a) {card_line()}: {FAILOVER_PROBES} healthy probes, round trip min "
          f"{out['probe_ms']['min']:.3f} / median {out['probe_ms']['median']:.3f} / max "
          f"{out['probe_ms']['max']:.3f} ms; healthy in {out['busy_probe_ms']:.3f} ms with a worker stream "
          f"in a {FAILOVER_BUSY_S} s device sleep (deadline {FAILOVER_DEADLINE_S} s); an ordinary error paid no "
          f"probe, a CUDA-shaped one one probe and no flip", flush=True)
    return out


def failover_scenario(root: str) -> dict:
    """Phase 20 (b): the ``full`` chaos scenario through
    ``resilience/scenarios.py`` on the card."""
    from anovos_tpu_torch.resilience import failover, scenarios
    from anovos_tpu_torch.shared.runtime import get_runtime

    card = get_runtime().device
    t0 = time.perf_counter()
    res = scenarios.run_scenario("full", os.path.join(root, "scenario"))
    wall = time.perf_counter() - t0
    rs = res.get("resilience", {})
    triggers = sorted((d["trigger"], d["node"]) for d in res.get("flightrec", []))
    check(res["ok"] and res["injections"] == 3 and res["failovers"] == 1 and rs.get("retries", 0) >= 3
          and rs.get("timeout_escalations", 0) >= 1 and not res["flightrec_missing"] and res["clean_flightrec"] == 0
          and res["parity"] and len(triggers) == 2 and res["runtime_after"] == "cpu",
          f"failover: the full scenario on the card: {json.dumps(res)}")
    check(get_runtime().device == card, f"failover: the scenario left the runtime on {get_runtime().device}")
    failover.reset()
    out = {"wall_s": wall, **{k: res.get(k) for k in ("clean_wall_s", "clean_cpu_wall_s", "chaos_wall_s", "injections",
                                                  "failovers", "cpu_parity_files", "post_flip_nodes")},
           "resilience": {k: rs.get(k) for k in ("retries", "timeout_retries", "failover_retries",
                                                 "timeout_escalations")},
           "flight": triggers}
    print(f"failover: (b) the full scenario on the card in {wall:.2f} s (clean {res['clean_wall_s']} s, clean on "
          f"the CPU {res.get('clean_cpu_wall_s')} s, chaos {res['chaos_wall_s']} s): ok, 3 injections, 1 failover, "
          f"{out['resilience']}, dumps {triggers}; {res['cpu_parity_files']} file(s) of the nodes after the flip "
          f"({res['post_flip_nodes']}) held to the clean CPU tree, the rest byte-equal to the clean card tree",
          flush=True)
    return out


def phase_failover(torch, seed: int) -> dict:
    """Phase 20: (a)-(c) of the module docstring."""
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.resilience import failover, scenarios
    from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime, runtime_generation

    t_phase = time.perf_counter()
    card = get_runtime().device
    tmp = tempfile.mkdtemp(prefix="anovos_failover_")
    out = {"rows": FAILOVER_ROWS}
    try:
        out["a"] = failover_probe(torch)
        out["b"] = failover_scenario(tmp)
        # (c) configs_full: a clean card leg, a clean CPU leg, a wedge leg
        _, main_dir, si = full_inputs(seed + 20, os.path.join(tmp, "full"), FAILOVER_ROWS)
        cfg = full_config(main_dir, si)
        walls = {}
        kernels.reset_launches()
        with NodeLaunches() as clean_launches:
            t0 = time.perf_counter()
            scenarios.run_leg(cfg, os.path.join(tmp, "clean"), "", "600")
            walls["clean"] = time.perf_counter() - t0
        clean_total = dict(kernels.LAUNCHES)
        for name in PATH_KERNELS["failover_clean"]:
            check(clean_total[name] > 0, f"failover: kernel {name} was not launched by the clean card leg")
        init_runtime("cpu")
        try:
            t0 = time.perf_counter()
            scenarios.run_leg(cfg, os.path.join(tmp, "clean_cpu"), "", "600")
            walls["clean_cpu"] = time.perf_counter() - t0
        finally:
            init_runtime(card)
        gen0 = runtime_generation()
        cache_dir = os.path.join(tmp, "wedge_cache")
        kernels.reset_launches()
        with NodeLaunches() as wedge_launches, KernelInputs(torch) as given:
            t0 = time.perf_counter()
            man = scenarios.run_leg(cfg, os.path.join(tmp, "wedge"), FAILOVER_WEDGE, "600", cache_dir=cache_dir)
            walls["wedge"] = time.perf_counter() - t0
        wedge_total = dict(kernels.LAUNCHES)
        check(get_runtime().device.type == "cpu", f"failover: the wedge leg ended on {get_runtime().device}")
        init_runtime(card)
        res, nodes = man["resilience"], man["scheduler"]["nodes"]
        check(res["failovers"] == 1 and res["failover_retries"] == 1 and nodes[FAILOVER_NODE]["attempts"] == 2,
              f"failover: the wedge leg's resilience {res}, {FAILOVER_NODE} {nodes[FAILOVER_NODE]}")
        check(res["degraded"] == [] and res["degraded_sections"] == {}, f"failover: degraded {res}")
        check(all(v["state"] == "done" for v in nodes.values()),
              f"failover: {[(n, v['state']) for n, v in nodes.items() if v['state'] != 'done']}")
        dumps = scenarios.flight_dumps(os.path.join(tmp, "wedge"))
        check([(t, n) for _, t, n in dumps] == [("backend_failover", FAILOVER_NODE)], f"failover: dumps {dumps}")
        with open(dumps[0][0]) as f:
            pre_flip = json.load(f)["extra"]["pre_flip"]
        check(pre_flip.get("backend") == card.type and pre_flip.get("wedged") is True,
              f"failover: the dump's pre_flip {pre_flip}")
        post = scenarios.post_flip_files(os.path.join(tmp, "wedge"), cache_dir, cfg)
        check(FAILOVER_NODE in post["nodes"], f"failover: the journal's nodes after the flip {post}")
        # launches: none by a node that ran after the flip, each other node
        # as many as in the clean card leg
        # (which of the stats nodes launches the shared describe varies from
        # run to run, so launches are compared summed over each side)
        clean_by, wedge_by = clean_launches.by_node(), wedge_launches.by_node()
        for name in clean_by:
            side = {False: 0, True: 0}
            for n, c in wedge_by.get(name, {}).items():
                side[n in post["nodes"]] += c
            expect = sum(c for n, c in clean_by[name].items() if n not in post["nodes"])
            check(side[True] == 0 and side[False] == expect,
                  f"failover: {name} launches by node {wedge_by.get(name)}, clean {clean_by[name]}, nodes after "
                  f"the flip {post['nodes']}")
        late = [(k, n) for k, n, g in wedge_launches.calls if g != gen0]
        check(not any(n in post["nodes"] for _, n in late), f"failover: launches after the flip {late}")
        after = {k: sum(1 for a in given.seen[k] if not a[0].is_cuda) for k in given.seen}
        before = {k: sum(1 for a in given.seen[k] if a[0].is_cuda) for k in given.seen}
        check(before == {k: wedge_total[k] for k in before}, f"failover: card calls {before}, launches {wedge_total}")
        for name in PATH_KERNELS["failover_wedge"]:
            check(wedge_total[name] > 0, f"failover: kernel {name} was not launched before the flip")
        _, checked = given_kernel_rows(torch, given, "failover wedge", {tuple(a[0].shape) for v in given.seen.values()
                                                                         for a in v})
        del given
        par = scenarios.parity(scenarios.tree_files(os.path.join(tmp, "wedge")),
                               scenarios.tree_files(os.path.join(tmp, "clean")),
                               scenarios.tree_files(os.path.join(tmp, "clean_cpu")), post["files"])
        check(par["parity"], f"failover: the wedge tree differs from both clean trees: {par['differ'][:12]}")
        failover.reset()
        flight.reset()
        out["c"] = {"walls_s": walls, "launches_clean": clean_total, "launches_wedge": wedge_total,
                    "calls_before_flip": before, "calls_after_flip": after, "in_flight_after_flip": len(late),
                    "post_flip_nodes": post["nodes"], "cpu_parity_files": par["cpu_parity_files"],
                    "files": len(scenarios.tree_files(os.path.join(tmp, "wedge"))), "held_to_plain": checked,
                    "pre_flip": pre_flip}
        print(f"failover: (c) {card_line()}: configs_full on {FAILOVER_ROWS} rows, clean on the card "
              f"{walls['clean']:.2f} s, clean on the CPU {walls['clean_cpu']:.2f} s, {FAILOVER_WEDGE} "
              f"{walls['wedge']:.2f} s: 1 failover, {FAILOVER_NODE} 2 attempts, nothing degraded, the dump's "
              f"pre_flip {pre_flip}; launches clean {clean_total}, wedge {wedge_total} (B1/B2 calls before the flip "
              f"{before}, after it on the CPU {after}; {len(late)} launch(es) after the flip by nodes in flight); "
              f"nodes after the flip {post['nodes']}; {out['c']['files']} files, {par['cpu_parity_files']} held to the "
              f"clean CPU tree, the rest byte-equal to the clean card tree", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if get_runtime().device != card:
            init_runtime(card)
        failover.reset()
    check(get_runtime().device == card and failover.failover_count() == 0,
          f"failover: the phase ends on {get_runtime().device} with {failover.failover_count()} flip(s)")
    out["launches"] = {"failover_clean": clean_total, "failover_wedge": wedge_total}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"failover: phase 20 in {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 21: the data-plane and continuum chaos scenarios
# ---------------------------------------------------------------------------
def dataplane_scenario(torch, what: str, path: str, run) -> tuple:
    """One scenario of phase 21 through its gate (``run``), the launch
    counts set to 0 just before it and read just after, every B1/B2 call
    recorded: its whole ``ok``, the path's kernels launched, each launch a
    call on the runtime's device.  Returns (result, launches, the recorded
    calls, wall)."""
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.shared.runtime import get_runtime

    device = get_runtime().device
    kernels.reset_launches()
    with KernelInputs(torch) as given:
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(res.get("ok") is True, f"dataplane: {what}: {json.dumps(res, default=str)[:6000]}")
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"dataplane: {what}: kernel {name} was not launched")
    for name, calls in given.seen.items():
        on_device = sum(1 for a in calls if a[0].device == device)
        check(on_device == launches[name], f"dataplane: {what}: {on_device} {name} calls on {device}, "
              f"{launches[name]} launches")
    return res, launches, given, wall


def held_at(torch, given, rows: int, path: str, what: str, b2: bool) -> dict:
    """B1 (and B2 with ``b2``) on the first call a scenario gave it at
    ``rows`` rows, on the runtime's device, against its plain version and
    timed (``b1_row``/``b2_row``)."""
    from anovos_tpu_torch.shared.runtime import get_runtime

    device = get_runtime().device
    out = {"masked_moments": [], "binned_histograms": []}
    for name, row in (("masked_moments", b1_row), ("binned_histograms", b2_row))[:2 if b2 else 1]:
        call = next((a for a in given.seen[name] if a[0].device == device and a[0].shape[1] == rows), None)
        check(call is not None, f"dataplane: no {name} call at {rows} rows on the {path} path: "
              f"{sorted({tuple(a[0].shape) for a in given.seen[name]})}")
        out[name].append(row(torch, *call, path, what))
    return out


def phase_dataplane_chaos(torch, seed: int) -> dict:
    """Phase 21: (a)-(c) of the module docstring (``seed`` unused: the
    scenarios' data come from their own seeds, 7 and 13)."""
    import pandas as pd

    from anovos_tpu_torch.resilience import scenarios
    from anovos_tpu_torch.shared.runtime import get_runtime

    t_phase = time.perf_counter()
    card = get_runtime().device
    tmp = tempfile.mkdtemp(prefix="anovos_dataplane_")
    out = {"launches": {}, "kernels": {"masked_moments": [], "binned_histograms": []}}

    def add(rows: dict) -> None:
        for k, v in rows.items():
            out["kernels"][k] += v

    try:
        # (a) corrupt-ingest, and the clean run over the parts it keeps
        ci = os.path.join(tmp, "corrupt_ingest")
        res, la, given, wall = dataplane_scenario(torch, "(a) corrupt-ingest", "dataplane_corrupt_ingest",
                                                  lambda: scenarios.run_scenario("corrupt-ingest", ci))
        check(res["quarantine_records"] == scenarios.EXPECT_QUARANTINE["corrupt-ingest"]
              and res["degraded"] == sorted(scenarios.EXPECT_DEGRADED["corrupt-ingest"])
              and res["flightrec"] == [] and res["clean_flightrec"] == 0 and res["clean_quarantined_parts"] == 0,
              f"dataplane: (a) corrupt-ingest: {json.dumps(res, default=str)[:6000]}")
        survivors = os.path.join(tmp, "survivors")
        cfg = scenarios.survivors_config(ci, survivors)
        t0 = time.perf_counter()
        scenarios.run_leg(cfg, os.path.join(tmp, "survivors_run"), "", "600")
        survivors_wall = time.perf_counter() - t0
        scenarios.reset_planes()
        chaos_files = scenarios.tree_files(os.path.join(ci, "chaos"))
        check(chaos_files == scenarios.tree_files(os.path.join(tmp, "survivors_run")),
              "dataplane: (a) the chaos tree differs from the clean run over the surviving parts")
        rows = len(pd.read_parquet(survivors))
        add(held_at(torch, given, rows, "dataplane_corrupt_ingest", f"the surviving {rows}-row block", b2=True))
        del given
        out["launches"]["dataplane_corrupt_ingest"] = la
        out["a"] = {"wall_s": wall, "survivors_wall_s": survivors_wall, "surviving_rows": rows,
                    "files": len(chaos_files), **{k: res[k] for k in ("clean_wall_s", "chaos_wall_s",
                                                                       "chaos_wall_bound_s", "injections",
                                                                       "quarantine_records", "degraded")}}
        print(f"dataplane: (a) {card_line()}: corrupt-ingest in {wall:.2f} s (clean {res['clean_wall_s']} s, "
              f"chaos {res['chaos_wall_s']} s, bound {res['chaos_wall_bound_s']} s), {res['injections']} "
              f"injections, quarantined {res['quarantine_records']}, degraded {res['degraded']}; the chaos tree's "
              f"{len(chaos_files)} files byte-equal to a clean run over parts 0 and 3 ({rows} rows, "
              f"{survivors_wall:.2f} s); launches {la}", flush=True)

        # (b) slowread-stream
        res, lb, given, wall = dataplane_scenario(
            torch, "(b) slowread-stream", "dataplane_slowread_stream",
            lambda: scenarios.run_slowread_stream(os.path.join(tmp, "slowread")))
        add(held_at(torch, given, scenarios.SLOWREAD_ROWS, "dataplane_slowread_stream",
                    f"a {scenarios.SLOWREAD_ROWS}-row chunk", b2=False))
        del given
        out["launches"]["dataplane_slowread_stream"] = lb
        out["b"] = {"wall_s": wall, **{k: res[k] for k in ("clean_wall_s", "chaos_wall_s", "chaos_wall_bound_s",
                                                           "serial_penalty_s", "injections", "stream_overlap_pct",
                                                           "stream_workers")}}
        print(f"dataplane: (b) {card_line()}: slowread-stream in {wall:.2f} s (clean {res['clean_wall_s']} s, "
              f"chaos {res['chaos_wall_s']} s, bound {res['chaos_wall_bound_s']} s against a serial penalty of "
              f"{res['serial_penalty_s']:.1f} s), {res['injections']} injections, overlap "
              f"{res['stream_overlap_pct']} with {res['stream_workers']} workers; launches {lb}", flush=True)

        # (c) feed-30d, with the incremental leg's fold wall of every day
        # read back from its journal before the gate is judged
        def feed_gate() -> dict:
            from anovos_tpu_torch.cache.journal import read_journal
            from anovos_tpu_torch.continuum.state import JOURNAL

            res = scenarios.run_feed_30d(os.path.join(tmp, "feed"))
            walls = [e["fold_wall_s"] for e in read_journal(os.path.join(tmp, "feed", "inc", "state", JOURNAL))
                     if e.get("event") == "step_end"]
            print(f"dataplane: (c) the incremental leg's fold wall by day (s): {walls}", flush=True)
            return res

        res, lc, given, wall = dataplane_scenario(torch, "(c) feed-30d", "dataplane_feed_30d", feed_gate)
        add(held_at(torch, given, scenarios.FEED_ROWS_PER_DAY, "dataplane_feed_30d",
                    f"a {scenarios.FEED_ROWS_PER_DAY}-row daily block", b2=True))
        del given
        out["launches"]["dataplane_feed_30d"] = lc
        out["c"] = {"wall_s": wall, **{k: res[k] for k in (
            "continuum_incremental_wall_s", "continuum_batch_wall_s", "continuum_day2_fold_s",
            "continuum_day30_fold_s", "continuum_day30_vs_day2", "e2e_continuum_fold_s", "continuum_quarantined",
            "continuum_batch_quarantined", "continuum_shift_alert_day", "drift_alerts",
            "drift_alerts_with_flight_context")}}
        print(f"dataplane: (c) {card_line()}: feed-30d in {wall:.2f} s (incremental "
              f"{res['continuum_incremental_wall_s']} s, batch {res['continuum_batch_wall_s']} s), byte parity, "
              f"quarantined {res['continuum_quarantined']} and {res['continuum_batch_quarantined']}, shift alert "
              f"on day {res['continuum_shift_alert_day']}, {res['drift_alerts_with_flight_context']} of "
              f"{res['drift_alerts']} drift alerts with flight context, fold day 2 {res['continuum_day2_fold_s']} "
              f"s, day 30 {res['continuum_day30_fold_s']} s ({res['continuum_day30_vs_day2']}x, median "
              f"{res['e2e_continuum_fold_s']} s); launches {lc}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(get_runtime().device == card, f"dataplane: the phase ends on {get_runtime().device}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"dataplane: phase 21 in {out['phase_s']:.1f} s", flush=True)
    return out


def kernel_rows(kres: dict, geo_kernels: dict, b3_blobs: dict, by_path: dict, sass) -> list:
    """The ``{"kernels": [...]}`` rows: each kernel at its own path's shape,
    with its launches there (``by_path``: launch counts per path) and the
    other shapes it was timed at riding along.  B3's library_ms: no single
    PyTorch call counts within-eps neighbours without materialising the
    (n, n) distances.  B3's row also carries its launch plan and its pair
    loop's instructions a pair (``sass``, phase 1) with the ceiling they
    set, (2d + 3) / (2 x instructions)."""
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.kernels.neighbor_counts import launch_plan

    kres["masked_moments"]["other_shapes"].append(geo_kernels["masked_moments"])
    b3 = geo_kernels["neighbor_counts"]
    n, d = b3["shape"]
    per_pair = sass["per_pair"] if sass else None
    kres["neighbor_counts"] = {**b3, "library_ms": None, "other_shapes": [b3_blobs],
                               "max_abs_err": max(b3["max_abs_err"], b3_blobs["max_abs_err"]),
                               "launch_plan": dict(zip(("query_tiles", "source_splits", "split_points",
                                                        "tile_rows"), launch_plan(n, d, "cuda"))),
                               "instructions_per_pair": per_pair,
                               "ceiling_share": (2 * d + 3) / (2 * per_pair) if per_pair else None}
    own_path = {"masked_moments": "income", "binned_histograms": "income",
                "neighbor_counts": "geo_grid_16384"}
    rows = []
    for kname, meta in kernels.KERNELS.items():
        r = kres[kname]
        rows.append({"name": kname, "route": meta["route"], "source": meta["source"],
                     "replaces": meta["replaces"], "launches": by_path[own_path[kname]][kname],
                     "launches_by_path": {p: n[kname] for p, n in by_path.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"],
                     "warm_ms": {q: r["warm"][q] for q in ("min", "median", "max")},
                     "cold_ms": ({q: r["cold"][q] for q in ("min", "median", "max")}
                                 if "cold" in r else None),
                     "host_us": r.get("host_us"),
                     **{k: r[k] for k in ("launch_plan", "instructions_per_pair", "ceiling_share")
                        if k in r},
                     "other_shapes": r.get("other_shapes", [])})
    return rows


def result_line(torch) -> str:
    """The last line: the card the run used and the cards there are."""
    return json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}})


def print_codec_walls(path: dict, quality: dict, ts: dict, runner: dict) -> None:
    """The walls of the steps the host codec now runs, beside their walls
    before the codec."""
    blocks = runner["block_times_s"]
    now = dict(zip(BEFORE_CODEC_WALLS, (path["ingest_s"], quality["walls_s"]["join_read_main_parquet"],
                                quality["walls_s"]["write_avro"], quality["walls_s"]["read_avro"], ts["setup_s"],
                                runner["wall_s"] - sum(blocks.values()), blocks["join_dataset"])))
    for step, wall in now.items():
        print(f"codec walls: {step}: {wall:.3f} s (before the codec, three runs: {BEFORE_CODEC_WALLS[step]})",
              flush=True)
    print("codec_walls " + json.dumps(now), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    from anovos_tpu_torch.ops.kernels import build
    from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime

    init_runtime("cuda")
    # each phase's wall, printed at the end: the script must stay well
    # inside its 1,200 s limit on a host slower than the one it was tuned on
    walls, mark = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        walls[name], mark[0] = round(now - mark[0], 3), now
        print(f"phase {name}: {walls[name]:.1f} s, {now - t_start:.1f} s in all", flush=True)
        # only phase 20 flips, and it flips back: every phase ends on the card
        check(get_runtime().device.type == "cuda", f"phase {name} ended on {get_runtime().device}")

    device_name = torch.cuda.get_device_name(0)
    print(f"device: {device_name}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    try:
        build.load()
    finally:
        for src, log in build.BUILD_LOG.items():
            for line in log.splitlines():
                if "ptxas info" in line and ("Used" in line or "spill" in line):
                    print(f"build: {src}: {line.strip()}", flush=True)
    build_s = time.perf_counter() - t0
    print(f"build: {len(build.SOURCES)} sources, one nvcc each, all at once, in {build_s:.2f} s",
          flush=True)
    sass = b3_loop_sass(str(build.build_dir() / "libneighbor_counts.so"))
    if sass is not None:
        sass.pop("text")
        print(f"build: neighbor_counts pair loop at d = 2 (SASS): {sass['instructions']} instructions "
              f"for {sass['pairs']} pairs, {sass['per_pair']:.4f} a pair; {sass['mix']}", flush=True)
    else:
        print("build: no cuobjdump in the toolkit; neighbor_counts pair loop not counted", flush=True)

    from anovos_tpu_torch.shared import native

    cxx = subprocess.run([native.CXX, "--version"], capture_output=True, text=True).stdout.splitlines()
    zlib_h = subprocess.run([native.CXX, "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
                            capture_output=True, text=True).returncode == 0
    print(f"build: host codec compiler {cxx[0] if cxx else native.CXX + ' (no version)'}; zlib.h "
          f"{'found' if zlib_h else 'NOT found'}", flush=True)
    t0 = time.perf_counter()
    native.load()
    lib = native.library_path()
    codec_s = time.perf_counter() - t0
    print(f"build: host codec {lib.relative_to(lib.parents[3])} in {codec_s:.2f} s "
          f"({' '.join([native.CXX, *native.CXX_FLAGS, *native.LINK])}; compile "
          f"{native.BUILD_LOG[lib]['seconds']:.2f} s)" if lib in native.BUILD_LOG else
          f"build: host codec {lib} already built, loaded in {codec_s:.2f} s", flush=True)

    check(torch.get_float32_matmul_precision() == "highest" and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must not run in TF32")
    k_num = 9  # numeric columns of the income schema after the bench's drops
    lap("1 build")
    kres = phase_kernels(torch, args.seed, k_num)
    lap("2 kernels")
    path, table, df, extra = phase_path(torch, args.seed)
    print("path " + json.dumps({k: v for k, v in path.items() if k != "launches"}), flush=True)
    lap("3 path")
    b3_blobs = phase_geo_kernels(torch, args.seed)
    lap("4 geo kernels")
    geo = phase_geo(torch, args.seed)
    geo_kernels = geo.pop("kernels")
    print("geo " + json.dumps({k: v for k, v in geo.items() if k != "launches"}), flush=True)
    lap("5 geo")
    quality = phase_quality(torch, args.seed, table, df)
    quality_kernels = quality.pop("kernels")
    print("quality " + json.dumps({k: v for k, v in quality.items() if k != "launches"}), flush=True)
    lap("6 quality")
    assoc = phase_assoc(torch, args.seed, table, df)
    assoc_kernels = assoc.pop("kernels")
    print("association " + json.dumps({k: v for k, v in assoc.items() if k != "launches"}), flush=True)
    lap("7 association")
    ts = phase_timeseries(torch, args.seed, table, df, extra)
    del extra
    print("timeseries " + json.dumps(ts), flush=True)
    lap("8 timeseries")
    # phases 9 and 10d keep their inputs and runs here for phase 15
    runs_root = tempfile.mkdtemp(prefix="anovos_runs_")
    runner = phase_runner(torch, args.seed, runs_root)
    runner_kernels = runner.pop("kernels")
    print("runner " + json.dumps({k: v for k, v in runner.items() if k not in ("launches", "tree")}), flush=True)
    lap("9 runner")
    transform = phase_transformers(torch, args.seed, table, df, runs_root)
    del table
    transform_kernels = transform.pop("kernels")
    print("transformers " + json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "tree"} if k == "runner" else v)
                                        for k, v in transform.items() if k != "launches"}), flush=True)
    lap("10 transformers")
    scen = phase_scenarios(torch, args.seed)
    scen_paths = [p for p in PATH_KERNELS if p.startswith("configs_")]
    scen_kernels = {p: scen[p].pop("kernels") for p in scen_paths}
    print("scenarios " + json.dumps(scen), flush=True)
    lap("11 scenarios")
    geo_t = phase_geo_transformers(torch, args.seed)
    print("geo_transformers " + json.dumps(geo_t), flush=True)
    lap("12 geo transformers")
    stream_tmp = tempfile.mkdtemp(prefix="anovos_stream_")
    try:
        stream = phase_streaming(torch, args.seed, df, stream_tmp)
        feed = stream.pop("feed")
        stream_kernels = stream.pop("kernels")
        print("streaming " + json.dumps({k: v for k, v in stream.items() if k != "launches"}), flush=True)
        lap("13 streaming")
        cont = phase_continuum(torch, args.seed, df, feed, stream_tmp)
        del df, feed
    finally:
        shutil.rmtree(stream_tmp, ignore_errors=True)
    cont_kernels = cont.pop("kernels")
    print("continuum " + json.dumps({k: v for k, v in cont.items() if k != "launches"}), flush=True)
    lap("14 continuum")
    try:
        execu = phase_executor(torch, args.seed, runner, transform["runner"], runs_root)
        print("executor " + json.dumps(execu), flush=True)
        lap("15 executor")
        record = phase_record(torch, runner, execu["sequential"]["configs_basic"]["sequential"]["launches"],
                              runs_root)
        print("record " + json.dumps({k: v for k, v in record.items() if k not in ("launches", "tree")}),
              flush=True)
        lap("16 record")
        node_cache = phase_node_cache(torch, record, runner, runs_root)
        lap("17 node cache")
        live = phase_live_plane(torch, record, runner, runs_root)
        lap("18 live plane")
    finally:
        shutil.rmtree(runs_root, ignore_errors=True)
    print("node_cache " + json.dumps({k: v for k, v in node_cache.items() if k != "launches"}), flush=True)
    print("live_plane " + json.dumps({k: v for k, v in live.items() if k != "launches"}), flush=True)
    serving = phase_serving(torch, args.seed)
    serving_kernels = serving.pop("kernels")
    print("serving " + json.dumps({k: v for k, v in serving.items() if k != "launches"}), flush=True)
    lap("19 serving")
    fail_over = phase_failover(torch, args.seed)
    print("failover " + json.dumps({k: v for k, v in fail_over.items() if k != "launches"}), flush=True)
    lap("20 failover")
    dataplane = phase_dataplane_chaos(torch, args.seed)
    dataplane_kernels = dataplane.pop("kernels")
    print("dataplane_chaos " + json.dumps({k: v for k, v in dataplane.items() if k != "launches"}), flush=True)
    lap("21 dataplane chaos")
    print_codec_walls(path, quality, ts, runner)
    kres["masked_moments"]["other_shapes"].append(quality_kernels["masked_moments"])
    kres["masked_moments"]["other_shapes"] += assoc_kernels["masked_moments"]
    kres["masked_moments"]["other_shapes"] += runner_kernels["masked_moments"]
    kres["masked_moments"]["other_shapes"] += transform_kernels["masked_moments"]
    kres["masked_moments"]["other_shapes"] += serving_kernels["masked_moments"]
    kres["binned_histograms"]["other_shapes"] = ([quality_kernels["binned_histograms"]]
                                                 + runner_kernels["binned_histograms"]
                                                 + transform_kernels["binned_histograms"])
    for p in scen_paths:
        for kname in ("masked_moments", "binned_histograms"):
            kres[kname]["other_shapes"] += scen_kernels[p][kname]
    for kname in ("masked_moments", "binned_histograms"):
        kres[kname]["other_shapes"] += stream_kernels[kname] + cont_kernels[kname] + dataplane_kernels[kname]
    rows = kernel_rows(kres, geo_kernels, b3_blobs, {"income": path["launches"], **geo["launches"],
                                                     "quality": quality["launches"],
                                                     "association": assoc["launches"],
                                                     "timeseries": ts["launches"],
                                                     "runner": runner["launches"],
                                                     "transformers": transform["launches"],
                                                     **{p: scen[p]["launches"] for p in scen_paths},
                                                     "geo_transformers": geo_t["launches"],
                                                     "streaming": stream["launches"],
                                                     "continuum": cont["path_launches"],
                                                     "recommender": execu["recommender"]["launches"],
                                                     **{f"sequential_{w[len('configs_'):]}": r["sequential"]["launches"]
                                                        for w, r in execu["sequential"].items()},
                                                     "chaos": execu["chaos"]["launches"],
                                                     "run_record": record["launches"],
                                                     "node_cache": node_cache["launches"],
                                                     "live_plane": live["launches"],
                                                     **serving["launches"],
                                                     **fail_over["launches"],
                                                     **dataplane["launches"]}, sass)
    print("phase walls " + json.dumps(walls), flush=True)
    print(f"chip_smoke: phases 1-21 in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(result_line(torch), flush=True)


if __name__ == "__main__":
    main()
