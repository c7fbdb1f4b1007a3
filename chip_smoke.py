"""Smoke run of the PyTorch port (``oryx_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``); it exits non-zero
without a card, outside a checkout, or when any phase fails.  Phases:

1. Build every hand-written kernel from the sources in the checkout (one
   ``nvcc`` per source, started together; timed), print the card's name
   and power limit, and check that float32 matmuls run without TF32.
2. Hold each phase-A kernel against its plain PyTorch version on the
   card, at the shapes its served path gives it.  Each case prints one
   JSON line with the kernel's time, the plain version's, a PyTorch
   library yardstick's (never called by the port), the bound and the
   error:
   - ``phase_a`` (the store, float32 and bfloat16) at 5,111,808 rows (the
     store capacity of 5M items) x 250 features padded to 256, windows
     of 8, 32 and 256 queries, exact, and with LSH on a 1M-item store:
     block maxima within rtol 1e-5 (float32) or 1e-4 (bfloat16) plus the
     same figure as an absolute tolerance, for maxima near 0;
   - ``phase_a_i8`` (the int8 mirror, on the tensor cores) at 5,111,808
     x 256 (250 features) and x 64 (50 features), exact and LSH: int32
     maxima bit-identical;
   - ``phase_a_i8_fold`` (the folded int8 mirror, on the tensor cores)
     at 20,054,016 x 32 (10 features, fold 2), windows of 8, 32 and 256
     queries, exact and LSH: bit-identical to its plain version and to
     ``phase_a_i8`` on the unfolded mirror, which holds the two int8
     kernels against each other;
   - ``phase_a_fold`` (the folded store, float32 and bfloat16) at the
     same 10-feature shape, multiplying the 10 feature columns, within
     the tolerances of ``phase_a``;
   - coverage cases, labelled so, not served configurations: ``phase_a``
     at widths 32, 64 and 96 (1,048,576 rows, both dtypes, exact and LSH,
     8 and 256 queries) and at 300 queries (width 256, two query tiles);
     ``phase_a_i8`` at int8 widths 32 and 96 (1,048,576 rows, exact and
     LSH, 8 and 256 queries) and at 300 queries (width 256); both folded
     kernels at fold 4 (8 features, 1,048,576 rows, 8 queries), which
     runs their 8-column path, ``phase_a_i8_fold`` there at 256 queries
     too, and ``phase_a_i8_fold`` at fold 2 (10 features, 1,048,576
     rows) at 300 queries (two query tiles with the queries as the M
     side, of four m-tiles and of one) and at 272 (one tile of each
     orientation).
   Each case also prints the design it ran (``body``: "wgmma" on the
   tensor cores, "ffma" on the CUDA cores), its registers and spills from
   the compiler's output, its shared memory and ring depth, and its share
   of the bound (``bound_share``).
   Float kernels must give the plain version's -inf pattern and no NaN.
   The int8 quantizer on the card must equal the CPU's bit for bit on
   the first 1,048,576 rows of each quantized store.
3. Serve each configuration over HTTP through the port's HttpApp +
   TopNBatcher + StaticModelManager.  After the model loads, its
   measured-cost kernel route is installed (``refresh_route``, as the
   serving manager does at load) and printed as a ``route`` line: the
   exact and LSH cost tables, ``use_lsh``, the ``chosen`` kind, the
   static first kind, the seconds the measurement took and the launches
   it made.  The run fails if an eligible kind is missing from a table
   or any kind errored, or if the card holds more after the route than
   the store, the chosen kind's mirror and the LSH buckets.  Then one
   untimed round of concurrent /recommend, /recommendToMany and
   considerKnownItems requests (32 clients), then the same round timed,
   every answer checked against the same model's top-k with every
   phase-A kernel swapped for its plain version under the same route
   (and a few against the exact scan, with LSH only where the route
   serves it).  Every kernel's launch count is set to 0 before the
   timed round: the kernel of the route's chosen kind must have
   launched, and no other phase-A kernel.  One served window at each
   ladder size is timed first, with the int8 kinds' bound epilogue
   (query quantization and ``_i8_bounds``) timed apart.
   The two configurations that differ from the one before only in
   their int8 selection serve that model, re-routed, instead of a
   second load.
   Configurations (static first kind in brackets): 5M x 250 float32
   [pallas], 5M x 250 float32 with int8_selection="true" [i8], 5M x 250
   bfloat16 [pallas], 1M x 250 float32 LSH 0.3 [pallas], 5M x 50
   float32 [i8], 1M x 50 float32 LSH 0.3 [i8], 20M x 10 float32
   [i8_fold], and the same with int8_selection="false" [fold].  At
   20M x 10 [i8_fold] one more timed round (32 clients) serves
   /recommendToAnonymous with contexts of 1-8 items: each context's
   vector from the port's fold-in on the card must equal a host float64
   loop of the reference's formula (rtol 1e-4, atol 1e-5, and rtol 1e-4
   on the norm of the fold-in's change to the vector), each answer the model's top-k of that vector
   with the plain phase-A versions, and only the routed kind's kernel may
   launch; the Y^T Y solver is computed before the round.
4. Serve off the update topic: a ``ServingLayer`` started from
   ``oryx_tpu_torch/conf/als-example.conf`` (update topic on a
   temporary ``file://`` broker) replays one MODEL-REF naming a
   1M x 50 float32 model published in 8 slices (``publish_sliced``,
   written by a child process while phases 2-3 run), with sample rate
   0.3, then UP records for the 1,000 users with their known items
   (users u0-u63 with vectors 2^-13 as long, whose fold-in changes are
   far above float32 rounding).
   Once ``/ready`` answers and the route is measured, the load
   counters must read 8 slice loads, 0 fallbacks and a load time, both
   Gramian solvers must exist, the route must hold every eligible kind
   and no error, and the rounds of phase 3 run through the layer's own
   HTTP server and batcher, with the same checks.  Then, through the
   same layer: the fold-in round of phase 3 with /recommendToAnonymous
   and /recommendWithContext (users u0-u63) mixed; /similarity (2 and 5 items),
   /similarityToItem, /estimate, /estimateForAnonymous, /because,
   /mostSurprising, /mostActiveUsers, /mostPopularItems,
   /popularRepresentativeItems, /user/allIDs and /item/allIDs, each held
   against plain NumPy on the model's own arrays (the LSH ball, where
   the route serves it, from the model's item buckets); and POST and
   DELETE /pref and /ingest (plain, gzip, zip, multipart) onto the input
   topic the layer created on the same broker, read back from its
   ``file://`` log: every line exactly once, with the reference's key,
   in the partition ``partition_for_key`` gives, and a body with one bad
   line refused with 400 and nothing appended.  Each route prints a
   ``route_serve`` line with its request count, p50 and p99.
5. The batch and speed layers (their data made by a child process while
   phases 2-4 run):
   a. ALS trains on the card at MovieLens-20M's shape — 138,493 users x
      26,744 items, 20,000,000 drawn interactions of the port's
      synthesizer (seed 7), the reference bench's 5 % hold-out — as
      implicit ALS at rank 100 with lambda and alpha from
      reference.conf, 3 sweeps, the first untimed.  The factors must be
      finite with no rescue rung taken; 512 sampled rows of each side of
      the last half-sweeps must equal a float64 host solve of their
      normal equations from the same opposite factors within 1e-3 of the
      row's norm; the held-out AUC over 5,000 warm test users must pass
      0.6.  A ``train`` line gives each sweep's and half-sweep's seconds,
      the gather-and-product and solve seconds inside each half-sweep
      (CUDA events), the host packing seconds, the peak card memory and
      the AUC.
   b. The lambda loop through the port's layers, from
      ``oryx_tpu_torch/conf/als-example.conf`` on a temporary ``file://``
      broker at rank 100, 3 sweeps and 8 slices: 125,000 drawn
      interactions over 17,312 users (an eighth of MovieLens-20M's, at
      its density) and its 26,744 items on the input topic;
      one ``BatchLayer`` generation, which must commit its offsets,
      publish a MODEL-REF whose manifest names 8 slices and write a PMML
      with the features, lambda and implicit flag; a ``ServingLayer``
      and a ``SpeedLayer`` loading it (``/ready``, every id in both);
      2,000 ``/pref`` events for 256 users through the serving layer's
      HTTP; one ``SpeedLayer.run_one_micro_batch()``, whose UP records
      must equal a host float64 loop of the reference's fold-in on the
      speed model's own vectors (rtol 1e-4, atol 1e-5); then the serving
      layer must hold each user's last UP vector bit for bit, and each
      user's ``/recommend`` must be the NumPy top-10 of that vector with
      its known items excluded.  The batch and speed layers serve their
      side doors (``oryx.obs.metrics-port``) and every layer traces: the
      batch side door's ``/metrics`` must give the generation's freshness
      gauges, the speed side door's the micro-batch's, and the first
      ``/pref``, sent with a sampled ``traceparent``, must show up as a
      ``speed.fold_in`` span on the speed side door's ``/admin/traces``
      under the serving layer's request span of the same trace.  A
      ``lambda`` line gives the generation's seconds by stage, each
      layer's load seconds, the micro-batch's seconds, the milliseconds
      from the last ``/pref`` to the serving layer answering with the new
      vectors, and both side doors' gauges.
6. The IVF index and the k-means app (6b's generation made by a child
   process while the earlier phases run):
   a. The IVF index at the reference's protocol catalog, 10,485,760 x 50
      float32 items from a gaussian mixture of 256 components
      (bench/gateway.py's draw), with reference.conf's ANN settings:
      the serving manager's path trains the centroids, builds the mirror
      and measures the recall certificate, which must reach min-recall
      with no fallback; the route must time ``ivf``, ``i8`` and
      ``pallas`` with no error.  An ``ann`` line gives the recall, the
      index bytes, the build's seconds by stage, ``bpc``, the largest and
      mean cell, the cost table and the chosen kind.  At 8, 32 and 256
      queries a ``window`` line times the ``ivf`` kind, its probe and its
      phase B apart, ``i8`` and the routed kind, and the served window
      end to end; every row the IVF window certifies must be the exact
      top-k over its probed cells (ids in order, scores within rtol
      1e-5), and the ``i8`` kind's served answer (its own where it
      certifies, the exact rescan where not) wherever the exact top-k
      lies inside them.  With ``nprobe == cells``
      (64) on the first 2^20 items, every certified row must be the exact
      kernel's answer (``ann_exact`` line).
   b. (run last) A generation of 131,072 x 50 mixture items, published by
      the port's ``ALSUpdate`` with ``oryx.als.ann.publish-index`` (centroids
      and per-slice cells in an 8-slice manifest), loaded by a
      ``ServingLayer`` with the index on off a ``file://`` update topic
      (its streaming threshold lowered so the catalog takes the two-phase
      path): it must build the index from the published artifacts (no
      local k-means), with no fallback, a routable certificate and ``ivf``
      timed, and every user's ``/recommend`` must be the NumPy top-10
      over the rows the served kind considers (``ann_topic`` line).
   c. k-means on the card at the reference bench's shape (5,000,000 x 20,
      k = 100, 10 iterations, the bench's points) with the app's 3 runs,
      for ``random`` and ``k-means||``: each must pass the bench's gate,
      mean squared distance below 0.1 x the baseline variance; each Lloyd
      step of the random run's first run must match a float64 step from
      the same centers (plain torch on the card) within rtol 1e-4, and the
      four evaluation
      metrics on 20,000
      sampled points float64 NumPy's within rtol 1e-4 (``kmeans`` line:
      initialization and Lloyd seconds, seconds per metric, peak card
      memory).
   d. The k-means lambda loop from ``oryx_tpu_torch/conf/kmeans-example.conf``
      on a ``file://`` broker: 100,000 points on the input topic, one
      ``BatchLayer`` generation publishing the PMML, ``ServingLayer`` and
      ``SpeedLayer`` loading it; ``/assign`` (GET and POST) and
      ``/distanceToNearest`` against NumPy nearest centers; ``/add`` lines
      read back from the input topic; one speed micro-batch whose UP
      records must equal float64 moving averages, then held by the
      serving layer (``kmeans_loop`` line).
7. The random decision forest app:
   a. The forest trainer on the card at the reference bench's shape
      (bench/apps.py:103-165): 1,000,000 x 20 uniform predictors, label
      x0 + 0.5 x1 - 0.25 x2 > 0, a tenth held out, 20 trees, depth 10, 32
      bins, gini.  A cold build (seed 6) whose first three levels'
      histograms and slot counts must equal a CPU integer recount of the
      same slots and bootstrap weights, and each level's advance a NumPy
      walk of the same split tables; a warm build (seed 7) timed by the
      reference's stages.  Held-out accuracy on 50,000 sampled rows,
      scored by ``ForestArrays`` on the card, must reach 0.9 for both;
      ``predict_proba`` on 2,000 of them must equal the host walk
      (``DecisionForest.predict``) within 1e-6 with the same argmax (off
      a tie within 2e-6).  A regression forest at 100,000 x 20 (variance,
      target x0 + 0.5 x1 - 0.25 x2 plus 0.1 standard normal noise): its
      first level's histograms within 1e-5 of a float64 NumPy count
      (relative to each bin's absolute sum), its held-out RMSE below half
      the target's standard deviation.  An ``rdf`` line gives the cold and
      warm seconds, the warm stages, examples x trees per second, the
      peak card memory, the accuracies and the RMSE.
   b. The RDF lambda loop from ``oryx_tpu_torch/conf/rdf-example.conf``
      on a ``file://`` broker at the conf's settings: 100,000
      covtype-shaped lines (elevation and slope numeric, 40 soils, 7
      cover classes set by elevation band and soil, 5 % label noise), one
      ``BatchLayer`` generation publishing the PMML, ``ServingLayer`` and
      ``SpeedLayer`` loading it; ``/predict`` GET (the host walk) and POST
      (the forest walk on the card) over 1,000 rows against the host walk
      of the PMML read back, off ties; ``/classificationDistribution``
      and ``/feature/importance`` against the host forest; ``/train``
      lines read back from the input topic; one speed micro-batch whose
      UP records must equal a recount of the host walk (per tree, per
      terminal node, class counts), then held by the serving layer:
      ``/classificationDistribution`` must move by those counts
      (``rdf_loop`` line).

8. The benches and the probe kernels (``bench``):
   a. ``phase_a_qm`` (the queries as the tensor cores' M side, kernel 6's
      counterpart) against its plain version (``phase_a_reference``),
      exact and LSH, at 8, 32, 128, 256 and 300 queries on the probes'
      head shape (19,996,672 x 128 bf16 rows, buckets 0-127, one differing
      bit, every 11th row and one whole block retired, the last eighth of
      each window's queries zero) and at 8, 128 and 300 queries on
      1,048,576-row coverage shapes of widths 96 and 256: -inf in the same
      places, no NaN, finite maxima within rtol 1e-4, zero queries exactly
      0.  Each case names the instantiation that ran, its registers and
      spills, its time and its bound.
      ``phase_a`` is held the same way at the head shape and at the
      small-feature probe's two stores (kernels 5, 7 and 8).
   b. With every count set to 0: the port's ``lsh_mask_probe`` (its gate:
      the two LSH variants agree) and ``smallf_probe`` at their default
      shapes, one line per kernel with its time, bound, plain and library
      times; ``measure_peaks`` and ``measure_dispatch_floor``; one short
      grid cell through ``bench.grid.bench_config`` (1M x 50 bf16, LSH off
      and on, short rungs), whose answers for 32 sampled users must equal
      the same model's top-k with the plain phase-A versions (ids in
      order, scores within 1e-4).  ``phase_a_qm`` and ``phase_a`` must
      have launched.

9. The operator entry point (``deploy``), each step in processes of its
   own, from the checkout:
   a. ``python -m oryx_tpu_torch warmup`` with ``oryx.compile-cache-dir``
      a fresh directory, over items 1, 5 and 20 million x features 10,
      50 and 250: it must exit 0, build every ``csrc/*.cu`` library into
      ``<dir>/kernels`` (one ``nvcc`` each), and refuse nothing but by a
      kernel's width limit (``deploy_warmup`` line: wall and build
      seconds).  The same command again must find every library current
      and run no ``nvcc``.
   b. ``python -m oryx_tpu_torch serving`` from ``als-example.conf`` with
      that cache, off a ``file://`` update topic carrying phase 4's
      1M x 50 float32 model (LSH 0.3) and its 1,000 UP records: after
      ``/ready`` and the route, 64 ``/recommend`` answers must equal the
      same model's in this process with the plain phase-A versions (ids
      in order, scores within rtol 1e-5; under an LSH route, whose
      hyperplanes are drawn per process, the scores against exact dot
      products), the route's chosen kind must be a kernel kind, only its
      kernel may launch for the requests (the process logs its launch
      counts at the route and at exit), and SIGINT must end it with exit
      0 (``deploy_serve`` line).
   c. ``python -m oryx_tpu_torch.bench.coldstart`` (beside b, whose load
      it overlaps) at 200,000 ratings and
      rank 50 (its warmup and two children; ``deploy_coldstart`` line).
   The layers this script starts in its own process keep their libraries
   in ``build/kernels``: phase 1 sets the cache directory to ``build``
   before any layer starts, and the first configuration wins.

10. The observability surface (``obs``): a ``ServingLayer`` from
    ``als-example.conf`` with every obs key on (tracing at sample ratio
    1.0, an availability and a latency objective, the event log, the
    flight recorder with no debounce, ``profile-dir``) loads phase 4's
    1M x 50 model off a ``file://`` update topic of its own (the layer
    starts and its records are sent before phase 9, so that the load
    overlaps phase 9's processes).  256
    ``/recommend`` requests at 32 clients, for users u0-u255, run three
    times: untimed, with the sample ratio at 0, and at 1.0 with every
    count set to 0 (only the routed kind's kernel may launch).  The
    sampled answers must equal the plain phase-A versions' (ids in
    order, rtol 1e-5).  ``/metrics`` must count every request, book
    ``serve`` device time to the routed kind and ``measure`` time to the
    route, and give a ``device_busy_fraction`` in (0, 1]; the Prometheus
    text must carry the routed kind's ``oryx_device_time_us_serve_*``
    counter; every OpenMetrics exemplar must name a trace on
    ``/admin/traces``, where each sampled request's tree is
    ``serving.request`` over ``serving.queue_wait`` and
    ``serving.device_execute`` (its ``kernel_route`` the route, its
    ``batch_size`` at least 1), whose stages sum to the root.
    ``/admin/profile?ms=500`` during a fourth burst must write a Chrome
    trace holding events of the routed kernel's ``__global__``
    functions, and a second capture meanwhile must get 503 (``profile``
    line: the events and the card's busy share over the window from the
    trace's kernel events, beside ``device_busy_fraction``).  The event
    log must hold one line per sampled request with its batch fields, a
    ``POST /admin/flight/dump`` bundle the device time and the card's
    memory, and ``/admin/diagnose`` and ``/admin/slo`` must answer.  The
    ``obs`` line gives both rounds' p50 / p99 beside phase 4's, the
    mean batch, the stage shares, and ``bench.obs_overhead``'s
    per-request nanoseconds, run in this process, beside the
    reference's 10 µs budget for the unsampled pipeline.

11. The serving cluster on one card (``cluster``): two replicas, shards
    ``0/2`` and ``1/2``, each a ``ServingLayer`` from
    ``als-example.conf`` in a process of its own, load their halves of a
    1,179,648 x 50 float32 model (10,000 users, 9 known items each;
    published in 8 slices by a child process while the earlier phases
    run) off a ``file://`` update topic, and announce themselves with
    heartbeats; the router (``cluster/router.py``) runs in this
    process.  DIGEST credentials guard every door, the router's and the
    replicas' (the scatter hop answers their challenge).  Once both
    replicas have loaded and measured their routes (each must route a
    kernel kind, with no route error, 4 slice loads and no fallback),
    64 untimed ``/recommend``, then, with every count set to 0 in each
    replica, 256 ``/recommend`` and 32 ``/recommendToAnonymous`` (1-8
    context items) through the router at 32 clients: each replica's
    routed kernel must have launched and no other phase-A kernel.
    Every ``/recommend`` answer must equal the single-node exact scan
    over the whole catalog in this process (``exact_top_n``; ids in
    order, rtol 1e-5); every fold-in answer the exact top-10 of a
    float64 fold-in over the whole catalog's Gramian (``fold_in_f64``;
    ids in order, rtol 1e-4, atol 1e-5).  One ``/pref`` through the
    router must land on the input topic; the router's ``/metrics`` must
    show both shards live and covered, with no partial answer and no
    shard failure.  Then 256 ``/recommend`` straight to replica 0 (its
    shard alone), after 8 ``/recommendToAnonymous`` through the router
    one at a time.  A ``cluster_replica`` line per replica (routed kind,
    launches, load seconds) and a ``cluster`` line (seconds to the
    router's ``/ready`` and to both loads, the router's and replica 0's
    p50 / p99, the scatter's counters).

12. The serving cluster's fast path (``cluster_fast``), on phase 11's
    model directory (the publisher child runs for this phase alone
    too) sent as a MODEL-REF on a topic of this phase's own: two more
    replicas (``0/2``, ``1/2``, started and sent their MODEL-REF
    before phase 10, so that their start and load overlap phases 10-11,
    at least 15 s before phase 11's, so that the two pairs' route
    measurements do not overlap) with the
    framed transport
    (``oryx.cluster.transport.enabled``) and the shard cache
    (``replica-cache``), and a router in this process on the asyncio
    front end with the result cache and coalescing; DIGEST on every
    door and on the frame hop's AUTH frame.  Seven checks, each a
    failure of the run: (1) after 64 untimed requests, 256
    ``/recommend`` on users phase 11 did not send, at 32 clients, all
    ``X-Oryx-Cache: miss``, each equal to the single-node exact scan as
    in phase 11, each replica's routed kernel launched and no other;
    (2) ``transport_open_connections`` is 2, the HTTP/1.1 pool made no
    shard query, no hedge, shard failure or partial answer; (3) the
    same 256 again, all ``hit``, bodies byte-equal to the misses, no
    kernel launch in either replica; then phase 11's 32
    ``/recommendToAnonymous`` through the asyncio front end, held
    against the float64 fold-in; (4) a wave of 32 identical concurrent
    requests on a cold user, its leader held 0.5 s by the
    ``router-shard-timeout`` delay: one ``miss``, 31 ``coalesced``, one
    body; (5) a ``/pref`` through the router lands on the input topic,
    the speed layer's UP (the float64 fold-in of the event) goes on the
    update topic, and the user's next answer is a ``miss`` equal to the
    exact scan of the new vector; (6) a ``/shard/recommend`` repeated on
    the framed hop (``FrameTransport``) is a hit in replica 0's
    ``ShardResultCache`` and launches nothing; (7) ``/recommend`` over
    h2c with prior knowledge and over TLS with ALPN ``h2`` on replica
    0's HttpApp (a raw-socket client on the port's HPACK codec) gives
    the status and body of HTTP/1.1.  A ``cluster_fast_replica`` line
    per replica and a ``cluster_fast`` line (the miss and hit passes'
    p50 / p99, the fold-in round beside phase 11's, the wave, the loop
    lag, the caches' and the scatter's counters).

13. Two regions, the mirror and the autoscaler (``regions``).  Region A
    is phase 11's update topic (its 1,179,648 x 50 float32 model; with
    ``--phases regions`` alone this phase starts the publisher child and
    sends the MODEL-REF itself).  Region B, on a ``file://`` broker of
    its own, is two replicas (``0/2``, ``1/2``, processes of their own
    on the card), a ``python -m oryx_tpu_torch router`` and a
    ``python -m oryx_tpu_torch autoscale`` against that router, all
    started before phase 11; a ``python -m oryx_tpu_torch mirror``
    process replays A's topic into B's from the moment phase 11's
    MODEL-REF is on it, so that B's loads overlap phases 11-12.  Once
    B's router is ready, still during phases 11-12, 48 clients of
    ``/recommendToAnonymous`` hold its p99 above the autoscaler's 500 ms
    bound until the autoscaler spawns a member (``serving --shard 0/2``,
    the thinnest group, on the card), whose load then overlaps the rest;
    a trickle of one ``/recommend`` at a time (each answer held against
    the exact scan) keeps the p99 between the two bounds, neither
    pressure nor calm, until the member has been checked.  The checks,
    each a failure of the run, as is any process that dies unexpectedly:
    (a) B's replicas loaded their halves through the mirror and routed a
    kernel kind; 64 ``/recommend`` through B's router equal the
    single-node exact scan (ids in order, rtol 1e-5), and each replica's
    routed kernel launched in that round and no other; (b) 32 ``UP``
    records for known users appended to A: B answers each user with the
    exact top-10 of the new vector (milliseconds from the append); (c)
    the A -> B mirror is stopped (a partition), 2,000 ``UP`` records
    accumulate on A, then the mirror restarts with
    ``mirror-crash-mid-replay`` armed as ``crash`` once (its first batch
    is sent, the crash ends the process), again with it armed as
    ``hold`` (the second batch is sent and the process is killed at the
    point, before its checkpoint), and a third time clean: its dedup
    skips equal the killed batch, every (``origin-region``,
    ``origin-partition``, ``origin-offset``) triple in B's topic is
    unique, and the backlog is there exactly once; (e) the member is
    live and ready in the router's membership, ``/admin/topology``
    counts 3 replicas of 2 shards, 64 ``/recommend`` still equal the
    exact scan, 64 more on the member's own door (its shard alone)
    answer, its route is a kernel kind; then the trickle stops, calm
    retires the member (2 replicas again) and it logs its launches,
    which must include its routed kernel's; (d) a B -> A mirror runs beside from (c) on; after B's
    fleet stops, 8 records born in B reach A and come back to no one:
    both topics' ends stay put over 3 polls and both mirrors counted
    loop drops.  A ``regions_replica`` line per process of B (routed
    kind, launches) and a ``regions`` line (B's seconds to ``/ready``,
    its ``/recommend`` p50 / p99, the UP propagation, the lag and
    steady staleness, catch-up records/s over the healed partition,
    dedup skips, loop and heartbeat drops, the autoscaler's signal,
    spawn to member ready and retirement seconds).
14. The sharded speed layer over the Kafka wire protocol
    (``speed_shard``), on phase 5b's generation (``--phases speed_shard``
    alone makes 5b's data and generation itself).  Right after phase 5b
    the port's ``MiniKafkaBroker`` starts in this process on
    ``127.0.0.1:0``, ``python -m oryx_tpu_torch kafka-setup`` makes the
    input (4 partitions) and update (1) topics at its address, 5b's
    MODEL-REF record (rank 100, 8 slices, its manifest envelope) is
    copied onto the wire update topic, and ``speed --shard 0/2`` and
    ``1/2`` start on the card with ``oryx.speed.checkpoint-dir`` and
    their side doors, so that their loads overlap phases 6-13.  Both
    hold their first UP publish 3 s (``speed-publish`` armed as a delay
    once), so that both fold against the generation; worker 0 also arms
    ``speed-crash-mid-batch`` as ``crash`` once.  Phase 14 sends 5b's
    2,000 /pref events through the port's ``KafkaTopicProducer`` in one
    Produce request.  Each a failure of the run: (a) worker 0 dies after
    its batch's publishes and before its commit, its checkpoint's
    ``pending`` set, and restarted without the fault on the same
    checkpoint reports ``speed_shard_dedup_skips`` equal to that batch's
    UP count and republishes nothing; (b) every (``speed-shard``,
    ``speed-batch``, ``speed-seq``) triple on the update topic is
    unique, every aggregated (user, item) pair has its X and its Y
    record exactly once across the workers, and each worker folded only
    items its ring slot owns (its logged skips are the ring's count);
    (c) every UP vector lies within rtol 1e-4, atol 1e-5 of phase 5b's
    float64 host loop on the generation's vectors; (d) each worker's
    committed input offsets (OffsetFetch over the wire) and its
    checkpoint's fence equal the input's end offsets, nothing pending.
    A ``speed_shard`` line: each worker's spawn-to-loaded, model-load
    and build seconds, worker 1's micro-batch seconds, the events each
    folded and skipped, the UP records, the dedup skips, the seconds
    from restart to recovery, and the phase's seconds.
15. Several devices (``mesh``) on one card: a mesh of two entries of
    ``cuda:0`` runs the code that two cards run, so this phase holds
    correctness and each entry's overhead, not the speed of two cards.
    Each a failure of the run:
    (a) an ``ALSServingModel(item_shards=2, mesh=...)`` over phase 3's
    5M x 250 bfloat16 vectors (phase 3's model, kept, and frozen out of
    the garbage collector's passes until here; built from the seed when
    phase 3 did not run) answers
    256 users at 8 and at 256 queries a window as the one-entry model
    does: the same ids in order but for near-ties within the bfloat16
    margin (rtol 1e-4; counted, at most 1 % of the rows), scores within
    rtol 1e-4; each model's window milliseconds at both sizes;
    (b) ``train_als_distributed`` in the gather and the ring mode at
    rank 100 over a random sample of phase 5a's interactions, as many
    as keep the dense blocks within ``MESH_ALS_SLOTS`` slots (P the
    next power of two of the longest row), 2 sweeps, against the port's
    ``train_als`` at the same seed within rtol 2e-3 and atol 2e-3;
    (c) ``train_kmeans_distributed`` at phase 6c's width (20 features,
    k = 100, k-means|| initialization) on 1,000,000 points, against its
    one-entry run from the same initial centers (each center within 0.25
    of the other run's nearest, both ways; the mean squared distance
    within 0.1 %); ``train_forest(mesh=...)`` at phase 7's widths (20 predictors,
    20 trees, 32 bins) on 250,000 examples at depth 8: the
    classification forest equal to the one-entry forest (importances
    and held-out predictions), the regression forest's RMSE within 5 %
    of the one-entry forest's and below half the target's deviation;
    (d) ``initialize_multihost`` joins a one-process NCCL group at
    ``127.0.0.1:<free port>`` and one ``all_reduce`` runs through the
    mesh's cross-process sum.  A ``mesh`` line gives each part's seconds
    and checks.

Every process of the run writes its standard error into this
process's; a line saying a thread ran CUDA work with no current CUDA
context fails the run.

``--phases`` runs a subset (comma-separated names: serving = phases 2-3,
topic = 4, lambda = 5, ann = 6a-b, kmeans = 6c-d, rdf = 7, bench = 8,
deploy = 9, obs = 10, cluster = 11, cluster_fast = 12, regions = 13,
speed_shard = 14, mesh = 15); the default runs every phase. A
partial run still ends with the two summary lines, its ``kernels`` line
listing only what it ran.

With ``--trace DIR`` the fold-in round of phase 4 runs once more, after
the timed one, under ``torch.profiler``: its operator tables and Chrome
trace go under DIR, and a ``trace`` line gives the round's wall time,
the host's time in blocking CUDA calls, the copies, and the device's
busy time and idle share.

An exception that ends any thread of the run fails it.  The line
before the last is a JSON ``{"kernels": [...]}`` summary: each kernel's
``launches`` are the timed round of the first configuration whose
route chose it (``served_config``; the head configuration where its
route did), and ``route_launches`` that configuration's route
measurement (``deploy_launches`` phase 9's CLI-served process,
``obs_launches`` phase 10's sampled round, ``cluster_launches`` and
``cluster_fast_launches`` each replica's routed round in phases 11 and
12, ``regions_launches`` each region-B process's in phase 13: the
replicas' timed round and the autoscaled member's requests); a kernel
that served no timed
round fails the run.  The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import http.client
import json
import multiprocessing
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 20261017
FEATURES = 250
N_ITEMS = 5_000_000
N_LSH_ITEMS = 1_000_000
N_FOLD_ITEMS = 20_000_000
LSH_RATE = 0.3
N_USERS = 1000
KNOWN_PER_USER = 9
WINDOWS = (8, 32, 256)
COVERAGE_ROWS = 1 << 20
COVERAGE_FEATURES = 8
# phase_a coverage: the widths 32- and 64-feature models serve on, and
# one that is not a multiple of 64; a window above 256 queries
COVERAGE_WIDTHS = (32, 64, 96)
# phase_a_i8 coverage: int8 widths that take 32-byte chunks
I8_COVERAGE_WIDTHS = (32, 96)
COVERAGE_WINDOWS = (8, 256)
WIDE_WINDOW = 300
# phase_a_i8_fold coverage: two query tiles, one of each orientation
# (256 queries on the M side, 16 on the N side)
MIXED_WINDOW = 272
QUANT_CHECK_ROWS = 1 << 20
# rows per library call of the folded and int8 yardsticks: bounds their
# (rows, B) score tiles
LIBRARY_CHUNK_ROWS = 1 << 22
REPS = 10
DEVICE = "cuda"
# phase 4: the update-topic load, at the reference's published 1M x 50
# LSH setting (BASELINE.md:37)
N_TOPIC_ITEMS = 1_000_000
TOPIC_FEATURES = 50
TOPIC_RING = 8
TOPIC_SEED = SEED + 4
TOPIC_WAIT_S = 900.0
# the fold-in routes: contexts of 1-8 items with strengths, each
# context's vector held against a host float64 loop of the reference's
# formula; the other routes of phase 4 take a few requests each
CONTEXT_SEED = SEED + 7
MAX_CONTEXT = 8
FOLD_RTOL, FOLD_ATOL = 1e-4, 1e-5
# /recommendWithContext's users: u0..u63 of the topic model have vectors
# 2^-13 times as long (exact in float32, so their scores and orders are
# the unscaled ones', scaled).  Against Y^T Y ~ 1e6 I a context moves
# such a vector by a few percent, far above its float32 rounding, so the
# fold-in's own change is held at FOLD_RTOL; on an O(1) vector the change
# is ~10 ulps and no check could see it
SMALL_USERS = 64
SMALL_USER_SCALE = 2.0 ** -13
N_SURFACE = 8
# what the card may hold after a route beyond the store, the chosen
# kind's mirror and the LSH buckets (allocator rounding, solver factors)
ROUTE_SLACK_BYTES = 32 << 20
# float32: summation order only; bfloat16: the certificate's own margin
RTOL = {"float32": 1e-5, "bfloat16": 1e-4}
# phase 5a: ALS training at MovieLens-20M's shape, rank 100 (BASELINE.md's
# north star), implicit, lambda and alpha from reference.conf; the
# reference bench's 5 % hold-out and its sample of AUC users
ML_USERS, ML_ITEMS, ML_RATINGS = 138_493, 26_744, 20_000_000
TRAIN_SEED = 7
TRAIN_RANK = 100
TRAIN_SWEEPS = 3
TEST_FRACTION = 0.05
AUC_USERS = 5_000
AUC_LEARNED = 0.6
ROW_CHECKS = 512
ROW_RTOL = 1e-3
# phase 5b: the lambda loop through the port's three layers on a file://
# broker, from oryx_tpu_torch/conf/als-example.conf; an eighth of
# MovieLens-20M's users at its density (cut from 1,000,000 interactions
# over all of them, then from 500,000 over half and from 250,000 over a
# quarter, so that the default run, phase 15 included, stays near 900 s)
LOOP_USERS = 17_312
LOOP_RATINGS = 125_000
LOOP_SEED = TRAIN_SEED + 1
LOOP_T0 = 1_700_000_000_000
LOOP_SLICES = 8
# below the generation's PMML (its user and item ids), so the model is
# published by reference with its slices, as a larger catalog would be
LOOP_MAX_MESSAGE = 1 << 16
PREF_EVENTS = 2_000
PREF_USERS = 256
LOOP_WAIT_S = 600.0
# phase 6a: the IVF index at the reference's protocol catalog (10M items,
# bench/gateway.py:87, :1878) rounded up to whole 4096-row tiles, at
# BASELINE.md:50's 50 features, with reference.conf's ANN settings (1024
# cells, nprobe 32, min-recall 0.95, recall@50 on 64 queries)
ANN_ITEMS = 10_485_760
ANN_FEATURES = 50
ANN_SEED = SEED + 11
# nprobe == cells on a smaller catalog: the first 2^20 items, 64 cells
ANN_EXACT_ITEMS = 1 << 20
ANN_EXACT_CELLS = 64
# phase 6b: the index published with its generation (ALSUpdate with
# oryx.als.ann.publish-index) and loaded by a ServingLayer.  The
# generation's JSON artifacts cost about 0.6 ms of host time per item on
# the card's machine, more under load, so the catalog is 131,072 items
# (one 128-row block per cell at 1,024 cells), and the serving model's
# streaming threshold is lowered for it (as the tests force it) so that
# its windows take the two-phase path where "ivf" serves
ANN_TOPIC_ITEMS = 131_072
ANN_TOPIC_FLAT_LIMIT = 1 << 20
ANN_TOPIC_USERS = 256
ANN_TOPIC_RING = 8
ANN_TOPIC_SEED = SEED + 12
# phase 6c: k-means at the reference bench's shape (bench/apps.py:22,
# BENCH_KMEANS_r05.json) with the app's default runs (reference.conf's
# oryx.kmeans.runs); the evaluation on a sample
KM_POINTS, KM_DIMS, KM_K, KM_ITERATIONS = 5_000_000, 20, 100, 10
KM_SEED = 5
KM_RUNS = 3
KM_EVAL_SAMPLE = 20_000
KM_RTOL = 1e-4
# phase 6d: the k-means lambda loop from oryx_tpu_torch/conf/kmeans-example.conf
KLOOP_POINTS = 100_000
KLOOP_PROBES = 64
KLOOP_SEED = SEED + 13
# phase 7a: the forest trainer at the reference bench's shape
# (bench/apps.py:103-165, BENCH_RDF_r05.json): 1M x 20 uniform predictors,
# a tenth held out, 20 trees, depth 10, 32 bins, gini; the accuracy gate
# on a 50,000-row sample of the held-out tenth
RDF_EXAMPLES, RDF_PREDICTORS = 1_000_000, 20
RDF_TREES, RDF_DEPTH, RDF_BINS = 20, 10, 32
RDF_SEED = 6
RDF_SAMPLE = 50_000
RDF_MIN_ACCURACY = 0.9
RDF_CHECK_LEVELS = 3
RDF_PROBA_ROWS = 2_000
RDF_PROBA_TOL = 1e-6
RDF_REG_EXAMPLES = 100_000
RDF_REG_RTOL = 1e-5
# phase 7b: the RDF lambda loop from oryx_tpu_torch/conf/rdf-example.conf
# at its own settings (20 trees; reference.conf's depth 8, 100 split
# candidates, entropy) over covtype-shaped lines
RLOOP_LINES = 100_000
RLOOP_SOILS = 40
RLOOP_NOISE = 0.05
RLOOP_PROBES = 1_000
RLOOP_POSTS = 8
RLOOP_DIST_PROBES = 32
RLOOP_TRAIN = 256
RLOOP_SEED = SEED + 14
# phase 8: the probes' head shape (docs/bench_diag/lsh_mask_probe.py:123,
# :127, smallf_probe.py:56, :63), phase_a_qm's windows and coverage shapes, and the
# short grid cell (grid.py's 50f/1M row, short rungs)
PROBE_ITEMS_M = 20.0
QM_WINDOWS = (8, 32, 128, 256, 300)
QM_COVERAGE_WIDTHS = (96, 256)
QM_COVERAGE_WINDOWS = (8, 128, 300)
GRID_ITEMS, GRID_FEATURES = 1_000_000, 50
GRID_SEED = SEED + 15
GRID_CHECK_USERS = 32
GRID_RUNGS = dict(sat_workers=64, measure_sec=2.0, min_sat_requests=1000,
                  ladder=(1.0,), descent=(0.5,), rung_sec=2.0,
                  low_requests=20)
# phase 9: the operator entry point, warmup and the kernel cache
DEPLOY_ITEMS = "1,5,20"
DEPLOY_FEATURES = "10,50,250"
DEPLOY_REQUESTS = 64
DEPLOY_USERS = 100
DEPLOY_WAIT_S = 300.0
COLD_RATINGS = 200_000
COLD_RANK = 50
# phase 10: the observability surface on phase 4's model
OBS_REQUESTS = 256
OBS_CLIENTS = 32
OBS_PROFILE_MS = 500
OBS_OVERHEAD_ITERATIONS = 100_000
# the reference's budget for the unsampled per-request obs pipeline (µs)
OBS_BUDGET_US = 10.0
# the phase-A kinds of a hand-written kernel
# phase 11: the serving cluster on one card
# 9 x 2^17 items: each shard's ~589,824 stay above the streaming path's
# 2^19 rows after the store's 2^17 rounding (cut from 2,097,152 so that
# the default run, phase 15 included, stays near 900 s)
CLUSTER_ITEMS = 1_179_648
CLUSTER_FEATURES = 50
CLUSTER_USERS = 10_000
CLUSTER_RING = 8
CLUSTER_SEED = SEED + 16
CLUSTER_REQUESTS = 256
CLUSTER_ANONYMOUS = 32
CLUSTER_CLIENTS = 32
CLUSTER_SERIAL = 8
CLUSTER_USER = "oryx-smoke"
CLUSTER_WAIT_S = 900.0
# phase 12: the serving cluster's fast path, on phase 11's model
FAST_WARM = 64
FAST_BURST = 32
# the coalescing wave's leader is held this long before its scatter
FAST_HOLD_S = 0.5
# phase 12's MODEL-REF goes this long before phase 11's (their loads
# overlap; their route measurements must not)
FAST_LEAD_S = 15.0
# phase 13: region B on phase 11's model through the mirror
REGION_USERS = 64
REGION_UPS = 32
REGION_BACKLOG = 2_000
REGION_BORN_B = 8
REGION_POLL_MS = 100
REGION_WAIT_S = 600.0
REGION_PROPAGATION_S = 60.0
# the autoscaler: p99 above the high bound is pressure, and no traffic
# at all is calm; the trickle's one-at-a-time /recommend sits between
AUTOSCALE_POLL_MS = 1_000
AUTOSCALE_P99_HIGH_MS = 500
AUTOSCALE_P99_LOW_MS = 1
AUTOSCALE_COOLDOWN_MS = 10_000
AUTOSCALE_CLIENTS = 48
AUTOSCALE_PRESSURE_S = 120.0
TRICKLE_GAP_S = 0.02
# the thinnest group is shard 0 (both hold one replica; lowest id first)
MEMBER_ID = "asg-0of2-1"
# phase 14: two speed workers over the Kafka wire broker on phase 5b's
# generation; each holds its first UP publish this long, so that both
# fold the generation before either's updates reach the other
SHARD_COUNT = 2
SHARD_HOLD_MS = 3_000
SHARD_WAIT_S = 300.0
# phase 15: two entries of the one card
MESH_ENTRIES = 2
MESH_USERS = 256
MESH_WINDOWS = (8, 256)
MESH_TIE_SHARE = 0.01
MESH_ALS_SLOTS = 1 << 26
MESH_ALS_SWEEPS = 2
MESH_ALS_TOL = 2e-3
MESH_KM_POINTS = 1_000_000
MESH_KM_ITERATIONS = 10
# against the one-entry run: 1/20 of the noise's scale (sqrt(20) per
# point) for the centers, 0.1 % for the mean squared distance
MESH_KM_CENTER_TOL = 0.25
MESH_KM_COST_RTOL = 1e-3
MESH_RDF_EXAMPLES = 250_000
MESH_RDF_DEPTH = 8
MESH_RDF_TREES = 20
# a thread's CUDA work with no current context (PyTorch warns so)
NO_CONTEXT = "no current CUDA context"
KERNEL_KINDS = ("pallas", "i8", "fold", "i8_fold")
REPO = os.path.dirname(os.path.abspath(__file__))

PHASES = ("serving", "topic", "lambda", "ann", "kmeans", "rdf", "bench",
          "deploy", "obs", "cluster", "cluster_fast", "regions",
          "speed_shard", "mesh")
REFERENCE = "oryx_tpu/app/als/serving_model.py"
KERNELS = {
    # wrapper: (TPU kernel it replaces, source, phase-A kind it serves)
    "phase_a": (f"{REFERENCE}:314", "oryx_tpu_torch/csrc/phase_a.cu",
                "pallas"),
    "phase_a_fold": (f"{REFERENCE}:433",
                     "oryx_tpu_torch/csrc/phase_a_fold.cu", "fold"),
    "phase_a_i8_fold": (f"{REFERENCE}:702",
                        "oryx_tpu_torch/csrc/phase_a_i8_fold.cu", "i8_fold"),
    "phase_a_i8": (f"{REFERENCE}:804", "oryx_tpu_torch/csrc/phase_a_i8.cu",
                   "i8"),
    # a probe kernel: no route serves it
    "phase_a_qm": ("docs/bench_diag/lsh_mask_probe.py:67",
                   "oryx_tpu_torch/csrc/phase_a_qm.cu", None),
}


# exceptions that ended a thread of this process (the serving layer's
# consumer, the solver recomputes, the HTTP workers): any fails the run
THREAD_ERRORS: list[str] = []
# the run's standard error, searched for NO_CONTEXT (main sets it)
STDERR_WATCH = None


def thread_failed(args) -> None:
    if not issubclass(args.exc_type, SystemExit):
        THREAD_ERRORS.append(f"{getattr(args.thread, 'name', '?')}: "
                             f"{args.exc_type.__name__}: {args.exc_value}")
    threading.__excepthook__(args)


# the run's clock: each JSON line but the last two carries its seconds
# since the script started (``at_s``), from which each phase's share
# follows
_STARTED = time.perf_counter()


def log(obj) -> None:
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _STARTED, 3)}
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def wrappers() -> dict:
    """Phase-A wrapper modules by kernel name; each counts its kernel's
    launches in ``LAUNCHES``."""
    from oryx_tpu_torch.ops import phase_a, phase_a_fold, phase_a_i8
    from oryx_tpu_torch.ops import phase_a_i8_fold, phase_a_qm
    return {"phase_a": phase_a, "phase_a_fold": phase_a_fold,
            "phase_a_i8": phase_a_i8, "phase_a_i8_fold": phase_a_i8_fold,
            "phase_a_qm": phase_a_qm}


def reset_launches() -> None:
    for mod in wrappers().values():
        mod.LAUNCHES = 0


def read_launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in wrappers().items()}


@contextlib.contextmanager
def plain_phase_a():
    """Swap every phase-A wrapper the serving model calls for its plain
    version: the model's own path, with no kernel in it."""
    from oryx_tpu_torch.app.als import serving_model as sm
    mods = wrappers()

    def fold_plain(*args, features=None, **kwargs):
        # the plain version multiplies every column of a slot
        return mods["phase_a_fold"].phase_a_fold_reference(*args, **kwargs)

    swaps = {"phase_a": mods["phase_a"].phase_a_reference,
             "phase_a_fold": fold_plain,
             "phase_a_i8": mods["phase_a_i8"].phase_a_i8_reference,
             "phase_a_i8_fold":
                 mods["phase_a_i8_fold"].phase_a_i8_fold_reference}
    saved = {name: getattr(sm, name) for name in swaps}
    try:
        for name, fn in swaps.items():
            setattr(sm, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(sm, name, fn)


def time_ms(torch, fn) -> float:
    """Median of REPS timed calls (CUDA events) after two warm-ups."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def build_model(features, Y, X, known, dtype, sample_rate=1.0,
                int8_selection="auto", y_ids=None):
    import torch
    from oryx_tpu_torch.convert import serving_model_from_arrays
    t0 = time.perf_counter()
    model = serving_model_from_arrays(
        features, True, x_ids=[f"u{u}" for u in range(len(X))], X=X,
        y_ids=y_ids or [f"i{j}" for j in range(len(Y))], Y=Y,
        known_items=known, sample_rate=sample_rate, dtype=dtype,
        device=DEVICE, int8_selection=int8_selection)
    vecs, _ = model.Y.device_arrays()
    model.X.device_arrays()
    torch.cuda.synchronize()
    log({"phase": "model", "items": len(Y), "features": features,
         "dtype": dtype, "sample_rate": sample_rate,
         "int8_selection": int8_selection, "rows": int(vecs.shape[0]),
         "width": int(vecs.shape[1]),
         "load_s": time.perf_counter() - t0})
    return model


def background(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on a thread of its own: its future."""
    from oryx_tpu_torch.common.device import bind_thread, thread_card
    pool = concurrent.futures.ThreadPoolExecutor(
        1, initializer=bind_thread, initargs=(thread_card(DEVICE),))
    future = pool.submit(fn, *args, **kwargs)
    pool.shutdown(wait=False)
    return future


def free() -> None:
    """Return the card memory of what the caller has dropped, and the
    cuBLAS workspaces (one per thread and stream that ran a product; the
    allocator counts them as allocated)."""
    import torch
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


# -- phase 2: each kernel against its plain version --------------------------

def compare(kernel: str, info: str, M, R, exact: bool, rtol: float | None,
            zero_rows: int) -> tuple[float, float]:
    """Hold the kernel's maxima ``M`` against the plain version's ``R``:
    bit for bit (integer kernels), or within ``rtol`` with the same -inf
    pattern and no NaN (float kernels).  The last ``zero_rows`` queries
    are zero: they score exactly 0 (or the retired-row penalty)."""
    import torch
    from oryx_tpu_torch.ops.phase_a_i8 import I8_PENALTY
    what = f"{kernel} {info}"
    b = M.shape[0]
    if exact:
        check(M.dtype == R.dtype == torch.int32, f"{what}: int32 maxima")
        check(torch.equal(M, R), f"{what}: maxima differ from the plain "
              "version")
        z = M[b - zero_rows:]
        check(bool(((z == 0) | (z <= I8_PENALTY // 2)).all()),
              f"{what}: zero query != 0")
        return 0.0, 0.0
    fin = torch.isfinite(R)
    check(bool((torch.isfinite(M) == fin).all()),
          f"{what}: -inf pattern differs from the plain version")
    check(not bool(torch.isnan(M).any()), f"{what}: NaN")
    diff = (M[fin] - R[fin]).abs()
    over = diff > rtol * R[fin].abs() + rtol
    check(not bool(over.any()),
          f"{what}: {int(over.sum())} block maxima beyond rtol {rtol}, "
          f"largest difference {float(diff.max()) if diff.numel() else 0}")
    z = M[b - zero_rows:]
    check(bool((z[torch.isfinite(z)] == 0).all()), f"{what}: zero query != 0")
    if not diff.numel():
        return 0.0, 0.0
    return (float(diff.max()),
            float((diff / R[fin].abs().clamp_min(1e-30)).max()))


def run_case(torch, kernel: str, fields: dict, kern, plain, library,
             nbytes: float, ops: float, op_rate: float, bw: float,
             exact: bool, rtol: float | None = None, also=None,
             extra: dict | None = None) -> dict:
    """One kernel case: compare, then time the kernel, the plain version
    and the library yardstick; ``also`` holds other results the kernel's
    maxima must equal bit for bit, ``extra`` more fields for the case's
    line."""
    info = " ".join(f"{k}={v}" for k, v in fields.items())
    M = kern()
    R = plain()
    torch.cuda.synchronize()
    max_abs, max_rel = compare(kernel, info, M, R, exact, rtol,
                               fields["B"] // 8)
    for name, other in (also or {}).items():
        check(torch.equal(M, other), f"{kernel} {info}: maxima differ from "
              f"{name}")
    del M, R
    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain)
    library_ms = time_ms(torch, library)
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / op_rate * 1e3
    case = {"phase": "kernel", "kernel": kernel, **fields,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_share": max(t_bytes, t_ops) / ms,
            "bytes": nbytes, "ops": ops,
            "max_abs_err": max_abs, "max_rel_err": max_rel, **(extra or {})}
    log(case)
    return case


def queries(torch, rng, b: int, features: int):
    """(B, features) queries on the card, the last eighth zero, as a
    window padded past its requests is."""
    q = rng.standard_normal((b, features), dtype=np.float32)
    q[b - b // 8:] = 0.0
    return torch.from_numpy(q).to(DEVICE)


def side_inputs(vecs, active, features: int, lsh: bool):
    """The store's own retired rows plus every 11th row retired, and the
    LSH buckets (sample rate 0.3) of the store when ``lsh``."""
    live = active.clone()
    live[::11] = False
    if not lsh:
        return live, None, None, 0
    from oryx_tpu_torch.app.als.lsh import LocalitySensitiveHash
    h = LocalitySensitiveHash(LSH_RATE, features, device=DEVICE)
    return (live, h.device_buckets(vecs), h._device_hyperplanes(),
            h.max_bits_differing)


def lsh_ok(torch, buckets, target, max_bits):
    from oryx_tpu_torch.app.als.lsh import _popcount
    return _popcount(torch.bitwise_xor(buckets[:, None],
                                       target[None, :])) <= max_bits


def ptxas_usage(source: str, variant: str) -> dict:
    """Registers and spilled bytes of one kernel instantiation, read from
    the compiler's output of ``source`` (``-Xptxas -v``)."""
    from oryx_tpu_torch.ops import cuda_build
    name, _, args = variant.partition("<")

    def arg(a: str) -> str:
        a = a.strip()
        return {"false": "Lb0E", "true": "Lb1E"}.get(a, f"Li{a}E")

    # Itanium mangling: phase_a_tc<256, 64> -> phase_a_tcILi256ELi64EE,
    # fold_wide<false, 16, ...> -> fold_wideILb0ELi16E...E
    mangled = name + ("I" + "".join(arg(a) for a in
                                    args.rstrip(">").split(",")) + "E"
                      if args else "")
    lines = cuda_build.LOGS.get(source, "").splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and mangled + "E" in line:
            text = " ".join(lines[k + 1:k + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            return {"registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": int(spill.group(1)) if spill else None}
    return {"registers": None, "spill_bytes": None}


def phase_a_cases(vecs, live, buckets, hp, mb: int, features: int,
                  stores, windows, rng, gpu_name, label=None) -> list[dict]:
    """``phase_a`` on the store ``vecs`` (rows ``live``, LSH when
    ``buckets`` is given), for every store dtype and window.  Each case
    also says which design ran (``body``), its registers and spills (from
    the compiler's output), its shared memory and ring depth."""
    import torch
    from oryx_tpu_torch.app.als import serving_model as sm
    from oryx_tpu_torch.app.als.lsh import _popcount
    from oryx_tpu_torch.bench.kernel_probe import datasheet
    from oryx_tpu_torch.ops import phase_a as pa

    bw, fp32_rate, bf16_rate, _ = datasheet(gpu_name)
    n, width = vecs.shape
    lsh = buckets is not None
    pen = sm._penalty_kernel(live, pa.BLOCK_ROWS).contiguous()
    flat_pen = pen.view(-1)
    out = []
    for dtype in stores:
        Y = vecs if vecs.dtype == dtype else vecs.to(dtype)
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        for b in windows:
            Q = queries(torch, rng, b, features)
            Qc = sm._q_cast(Q, Y).contiguous()
            tgt = sm._query_buckets(Q, hp) if lsh else None

            def library():
                s = torch.matmul(Qc, Y.T).float() + flat_pen
                if lsh:
                    ok = _popcount(buckets[None, :] ^ tgt[:, None]) <= mb
                    s = torch.where(ok, s, float("-inf"))
                return s.view(b, -1, pa.BLOCK_ROWS).amax(-1)

            nbytes = (Y.numel() * Y.element_size()
                      + Qc.numel() * Qc.element_size() + pen.numel() * 4
                      + b * (n // pa.BLOCK_ROWS) * 4
                      + (buckets.numel() * 4 + b * 4 if lsh else 0))
            design = pa.plan(width, b, dtype == torch.bfloat16)
            fields = {"store": name, "lsh": lsh, "rows": n,
                      "features": features, "width": width, "B": b,
                      "retired_rows": int((~live).sum())}
            if label:
                fields["label"] = label
            out.append(run_case(
                torch, "phase_a", fields,
                lambda: pa.phase_a(Qc, Y, pen, buckets, tgt, mb),
                lambda: pa.phase_a_reference(Qc, Y, pen, buckets, tgt, mb),
                library, nbytes, 2.0 * n * features * b,
                bf16_rate if name == "bfloat16" else fp32_rate, bw,
                exact=False, rtol=RTOL[name],
                extra={**design,
                       **ptxas_usage("phase_a.cu", design["variant"])}))
        del Y
    free()
    return out


def float_cases(model, rng, gpu_name, lsh: bool, stores) -> list[dict]:
    """``phase_a`` on this model's snapshot, for every store dtype and
    window."""
    vecs, active, version = model.Y.device_arrays_versioned()
    live = active.clone()
    live[::11] = False
    buckets = hp = None
    mb = 0
    if lsh:
        buckets = model._cached_buckets(vecs, version)
        hp = model.lsh._device_hyperplanes()
        mb = model.lsh.max_bits_differing
    return phase_a_cases(vecs, live, buckets, hp, mb, FEATURES, stores,
                         WINDOWS, rng, gpu_name)


def coverage_cases(rng, gpu_name) -> list[dict]:
    """``phase_a`` at the widths 32- and 64-feature stores have and at
    96 columns, on COVERAGE_ROWS rows, both dtypes, exact and LSH, at
    COVERAGE_WINDOWS; and one window of WIDE_WINDOW queries at 256
    columns, which takes two query tiles.  Labelled coverage: no served
    configuration runs these shapes here."""
    import torch
    out = []
    stores = [torch.float32, torch.bfloat16]
    for width, windows in [(w, COVERAGE_WINDOWS) for w in COVERAGE_WIDTHS] \
            + [(256, (WIDE_WINDOW,))]:
        vecs = torch.from_numpy(rng.standard_normal(
            (COVERAGE_ROWS, width), dtype=np.float32)).to(DEVICE)
        active = torch.ones(COVERAGE_ROWS, dtype=torch.bool, device=DEVICE)
        for lsh in ((False, True) if width != 256 else (False,)):
            live, buckets, hp, mb = side_inputs(vecs, active, width, lsh)
            out += phase_a_cases(vecs, live, buckets, hp, mb, width, stores,
                                 windows, rng, gpu_name, "coverage")
        del vecs
        free()
    return out


def i8_coverage_cases(rng, gpu_name) -> list[dict]:
    """``phase_a_i8`` at int8 widths 32 and 96 (32-byte chunks), on
    COVERAGE_ROWS rows, exact and LSH, at COVERAGE_WINDOWS; and one window
    of WIDE_WINDOW queries at width 256, which takes two query tiles.
    Labelled coverage: no served configuration runs these shapes here."""
    import torch
    out = []
    active = torch.ones(COVERAGE_ROWS, dtype=torch.bool, device=DEVICE)
    for width, windows in [(w, COVERAGE_WINDOWS) for w in I8_COVERAGE_WIDTHS] \
            + [(256, (WIDE_WINDOW,))]:
        vecs = torch.from_numpy(rng.standard_normal(
            (COVERAGE_ROWS, width), dtype=np.float32)).to(DEVICE)
        out += i8_cases(vecs, active, rng, gpu_name, width, windows,
                        "coverage")
        del vecs
        free()
    return out


def check_quantizer(vecs, label: str) -> None:
    """The quantizer on the card equals the CPU's bit for bit on the
    first QUANT_CHECK_ROWS rows."""
    import torch
    from oryx_tpu_torch.app.als import serving_model as sm
    part = vecs[:QUANT_CHECK_ROWS]
    got = sm._quantize_items_kernel(part, sm._BLOCK_ROWS)
    want = sm._quantize_items_kernel(part.cpu(), sm._BLOCK_ROWS)
    for g, w, name in zip(got, want, ("y8", "scale", "l1")):
        check(torch.equal(g.cpu(), w), f"{label}: quantizer {name} on the "
              "card differs from the CPU's")
    log({"phase": "quantizer", "store": label, "rows": int(part.shape[0]),
         "width": int(part.shape[1]), "bit_identical": True})


def int_mm_block_max(torch, y8_rows, q8_cols, pen_rows, buckets, target,
                     max_bits):
    """The library yardstick of the int8 kernels: ``torch._int_mm`` over
    row chunks, plus the penalty, the LSH replacement and the block max.
    ``y8_rows`` (N, w) int8, ``q8_cols`` (w, B) int8, ``pen_rows`` (N,)
    int32 in row order."""
    from oryx_tpu_torch.ops.phase_a_i8 import I8_PENALTY
    n = y8_rows.shape[0]
    b = q8_cols.shape[1]
    # _int_mm takes a multiple of 8 columns: zero queries past the window,
    # the columns kept column-major
    q8_cols = torch.nn.functional.pad(q8_cols.T, (0, 0, 0, -b % 8)).T
    outs = []
    for s0 in range(0, n, LIBRARY_CHUNK_ROWS):
        s1 = min(n, s0 + LIBRARY_CHUNK_ROWS)
        s = torch._int_mm(y8_rows[s0:s1], q8_cols)[:, :b]
        s += pen_rows[s0:s1, None]
        if buckets is not None:
            s.masked_fill_(~lsh_ok(torch, buckets[s0:s1], target, max_bits),
                           I8_PENALTY)
        outs.append(s.view(-1, 128, s.shape[1]).amax(1))
    return torch.cat(outs).T


def matmul_block_max(torch, y_rows, q_cols, pen_rows, buckets, target,
                     max_bits):
    """The library yardstick of the folded float kernel: one
    ``torch.matmul`` over the (N, w) view per row chunk, plus the
    penalty, the LSH mask and the block max."""
    n = y_rows.shape[0]
    outs = []
    for s0 in range(0, n, LIBRARY_CHUNK_ROWS):
        s1 = min(n, s0 + LIBRARY_CHUNK_ROWS)
        s = torch.matmul(y_rows[s0:s1], q_cols).float()
        s += pen_rows[s0:s1, None]
        if buckets is not None:
            s.masked_fill_(~lsh_ok(torch, buckets[s0:s1], target, max_bits),
                           float("-inf"))
        outs.append(s.view(-1, 128, s.shape[1]).amax(1))
    return torch.cat(outs).T


def i8_cases(vecs, active, rng, gpu_name, features: int, windows,
             label: str | None = None) -> list[dict]:
    """``phase_a_i8`` on the int8 mirror of ``vecs``, exact and LSH.  Each
    case also says which design ran, its registers and spills, its shared
    memory and ring depth."""
    import torch
    from oryx_tpu_torch.app.als import serving_model as sm
    from oryx_tpu_torch.bench.kernel_probe import datasheet
    from oryx_tpu_torch.ops import phase_a_i8 as pi8

    bw, _, _, i8_rate = datasheet(gpu_name)
    n, width = vecs.shape
    check_quantizer(vecs, f"{n}x{width}")
    y8, _, _ = sm._quantize_items_kernel(vecs, 128)
    out = []
    for lsh in (False, True):
        live, buckets, hp, mb = side_inputs(vecs, active, features, lsh)
        pen_i = sm._penalty_kernel_i32(live, 128)
        for b in windows:
            Q = queries(torch, rng, b, features)
            Qc = sm._q_cast(Q, vecs).contiguous()
            q8, _, _ = sm._quantize_queries(Qc)
            tgt = sm._query_buckets(Q, hp) if lsh else None
            q8_cols = q8.T
            nbytes = (y8.numel() + q8.numel() + pen_i.numel() * 4
                      + b * (n // 128) * 4
                      + (buckets.numel() * 4 + b * 4 if lsh else 0))
            fields = {"store": "int8", "lsh": lsh, "rows": n,
                      "features": features, "width": width, "B": b,
                      "retired_rows": int((~live).sum())}
            if label:
                fields["label"] = label
            design = pi8.plan(width, b)
            out.append(run_case(
                torch, "phase_a_i8", fields,
                lambda: pi8.phase_a_i8(q8, y8, pen_i, buckets, tgt, mb),
                lambda: pi8.phase_a_i8_reference(q8, y8, pen_i, buckets, tgt,
                                                 mb),
                lambda: int_mm_block_max(torch, y8, q8_cols, pen_i.view(-1),
                                         buckets, tgt, mb),
                nbytes, 2.0 * n * features * b, i8_rate, bw, exact=True,
                extra={**design,
                       **ptxas_usage("phase_a_i8.cu", design["variant"])}))
    del y8
    free()
    return out


def fold_cases(vecs, active, rng, gpu_name, features: int, windows,
               label: str, float_windows=None) -> list[dict]:
    """``phase_a_i8_fold`` at ``windows`` and ``phase_a_fold`` (float32 and
    bfloat16 stores) at ``float_windows`` (default: ``windows``) on the
    folded mirrors of ``vecs``, exact and LSH.  The int8 maxima must also
    equal ``phase_a_i8`` on the unfolded mirror; the int8 kernel's design
    as the built library reports it must be the one ``plan`` gives."""
    import torch
    from oryx_tpu_torch.app.als import serving_model as sm
    from oryx_tpu_torch.bench.kernel_probe import datasheet
    from oryx_tpu_torch.ops import phase_a_fold as pf
    from oryx_tpu_torch.ops import phase_a_i8 as pi8
    from oryx_tpu_torch.ops import phase_a_i8_fold as pi8f

    bw, fp32_rate, bf16_rate, i8_rate = datasheet(gpu_name)
    n, width = vecs.shape
    fold = sm._fold_eligible(width, features, 128)
    check(fold > 1, f"{label}: {features} features in {width} columns fold")
    w = width // fold
    check_quantizer(vecs, f"{n}x{width}")
    y8, _, _ = sm._quantize_items_kernel(vecs, 128)
    out = []
    for lsh in (False, True):
        live, buckets, hp, mb = side_inputs(vecs, active, features, lsh)
        bkt_f = sm._fold_buckets_kernel(buckets, fold, 128) if lsh else None
        pen_i = sm._penalty_kernel_i32(live, 128)
        y8f, pen_i_f = sm._fold_items_i8_kernel(y8, live, fold, 128)
        base = {"lsh": lsh, "rows": n, "features": features, "width": width,
                "fold": fold, "retired_rows": int((~live).sum()),
                "label": label}
        for b in windows:
            Q = queries(torch, rng, b, features)
            Qc = sm._q_cast(Q, vecs).contiguous()
            q8, _, _ = sm._quantize_queries(Qc)
            tgt = sm._query_buckets(Q, hp) if lsh else None
            unfolded = pi8.phase_a_i8(q8, y8, pen_i, buckets, tgt, mb)
            q8_cols = q8[:, :w].contiguous().T
            nbytes = (y8f.numel() + q8.numel() + pen_i_f.numel() * 4
                      + b * (n // 128) * 4
                      + (bkt_f.numel() * 4 + b * 4 if lsh else 0))
            design = pi8f.plan(fold, b, lsh)
            check(pi8f.library_plan(fold, b, lsh) == design,
                  f"{label}: phase_a_i8_fold's library plans "
                  f"{pi8f.library_plan(fold, b, lsh)}, plan() {design}")
            out.append(run_case(
                torch, "phase_a_i8_fold", {"store": "int8", **base, "B": b},
                lambda: pi8f.phase_a_i8_fold(q8, y8f, pen_i_f, bkt_f, tgt,
                                             mb, fold),
                lambda: pi8f.phase_a_i8_fold_reference(
                    q8, y8f, pen_i_f, bkt_f, tgt, mb, fold),
                lambda: int_mm_block_max(torch, y8f.view(n, w), q8_cols,
                                         pen_i.view(-1), buckets, tgt, mb),
                nbytes, 2.0 * n * features * b, i8_rate, bw, exact=True,
                also={"phase_a_i8 on the unfolded mirror": unfolded},
                extra={**design, **ptxas_usage("phase_a_i8_fold.cu",
                                               design["variant"])}))
            del unfolded
        del y8f, pen_i_f
        pen = sm._penalty_kernel(live, 128)
        for dtype in (torch.float32, torch.bfloat16):
            name = "bfloat16" if dtype == torch.bfloat16 else "float32"
            Y = vecs if vecs.dtype == dtype else vecs.to(dtype)
            yf, pen_f = sm._fold_items_kernel(Y, live, fold, 128)
            for b in (windows if float_windows is None else float_windows):
                Q = queries(torch, rng, b, features)
                Qc = sm._q_cast(Q, Y).contiguous()
                tgt = sm._query_buckets(Q, hp) if lsh else None
                q_cols = Qc[:, :w].contiguous().T
                nbytes = (yf.numel() * yf.element_size()
                          + Qc.numel() * Qc.element_size()
                          + pen_f.numel() * 4 + b * (n // 128) * 4
                          + (bkt_f.numel() * 4 + b * 4 if lsh else 0))
                design = pf.plan(w, b, dtype == torch.bfloat16, features)
                out.append(run_case(
                    torch, "phase_a_fold", {"store": name, **base, "B": b},
                    lambda: pf.phase_a_fold(Qc, yf, pen_f, bkt_f, tgt, mb,
                                            fold, features=features),
                    lambda: pf.phase_a_fold_reference(Qc, yf, pen_f, bkt_f,
                                                      tgt, mb, fold),
                    lambda: matmul_block_max(torch, yf.view(n, w), q_cols,
                                             pen.view(-1), buckets, tgt, mb),
                    nbytes, 2.0 * n * features * b,
                    bf16_rate if name == "bfloat16" else fp32_rate, bw,
                    exact=False, rtol=RTOL[name],
                    extra={**design, **ptxas_usage("phase_a_fold.cu",
                                                   design["variant"])}))
            del Y, yf, pen_f
    del y8
    free()
    return out


# -- phase 3: the served path ------------------------------------------------

def route_lsh(model) -> bool:
    """Whether the model's drains run the LSH mask under its route."""
    n_rows = len(model.Y.row_ids())
    return model._lsh_active() and model._route_use_lsh(n_rows)


def static_kinds(model) -> list[str]:
    from oryx_tpu_torch.app.als import serving_model as sm
    vecs, _ = model.Y.device_arrays()
    return model._phase_a_kinds(int(vecs.shape[0]), int(vecs.shape[1]),
                                sm._BLOCK_ROWS)[0]


def routed_kind(model) -> str:
    """The kind ``_dispatch_twophase`` takes for a drain of this model."""
    return model._route_order(static_kinds(model), len(model.Y.row_ids()),
                              lsh_on=route_lsh(model))[0]


def tensor_bytes(*objs) -> int:
    import torch
    total = 0
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            total += obj.numel() * obj.element_size()
        elif isinstance(obj, (tuple, list)):
            total += tensor_bytes(*obj)
    return total


def mirror_bytes(model) -> int:
    """Card bytes of the model's phase-A mirror caches and LSH buckets."""
    from oryx_tpu_torch.app.als import serving_model as sm
    return tensor_bytes(*(getattr(model, a) for a in sm._MIRROR_CACHES),
                        model._item_buckets)


def model_bytes(model, solvers) -> int:
    """Card bytes of everything the model keeps: both stores' snapshots,
    the LSH hyperplanes, the mirrors and buckets, the solver factors."""
    return (tensor_bytes(model.X._device, model.X._device_active,
                         model.Y._device, model.Y._device_active,
                         [s.cholesky for s in solvers])
            + (tensor_bytes(model.lsh._hp_dev) if model.lsh else 0)
            + mirror_bytes(model))


def check_route(model, label: str, route, seconds: float,
                launches: dict) -> dict:
    """Print the route line and fail on a missing kind, an error, a
    kept loser mirror, or a route the dispatch would not follow."""
    check(route is not None and route.get("measured"),
          f"{label}: no route measured")
    check("errors" not in route,
          f"{label}: route errors {route.get('errors')}")
    static = static_kinds(model)
    eligible = [k for k in static if k != "scan"]
    tables = [route["costs_exact_ms"]] + (
        [route["costs_lsh_ms"]] if route["lsh_configured"] else [])
    for table in tables:
        check(sorted(table) == sorted(eligible)
              and all(table[k] is not None for k in eligible),
              f"{label}: route table {table} lacks one of {eligible}")
    from oryx_tpu_torch.app.als import serving_model as sm
    chosen = route["chosen"]
    check(chosen in sm._KIND_MIRRORS, f"{label}: route chose {chosen!r}")
    check(routed_kind(model) == chosen,
          f"{label}: dispatch takes {routed_kind(model)!r}, route chose "
          f"{chosen!r}")
    kept = [a for a in sm._MIRROR_CACHES if getattr(model, a) is not None]
    check(set(kept) <= set(sm._KIND_MIRRORS[chosen]),
          f"{label}: mirrors {kept} kept beside the chosen {chosen}")
    for kind in eligible:
        wrapper = next(k for k, v in KERNELS.items() if v[2] == kind)
        check(launches[wrapper] > 0,
              f"{label}: measuring {kind} launched {wrapper} no time")
    line = {"phase": "route", "config": label, "static_kind": static[0],
            "chosen": chosen, "use_lsh": route["use_lsh"],
            "costs_exact_ms": route["costs_exact_ms"],
            "costs_lsh_ms": route.get("costs_lsh_ms"),
            "seconds": seconds, "launches": launches, "kept": kept}
    log(line)
    return line


def route_model(model, label: str, force: bool = False) -> dict:
    """Install the model's route as the serving manager does at load
    (``force``: measure anew, for a model whose kind chain changed), and
    check that the card then holds only the chosen kind's mirror beyond
    what it held before."""
    import torch
    free()
    torch.cuda.synchronize()
    before, mirrors_before = torch.cuda.memory_allocated(), \
        mirror_bytes(model)
    reset_launches()
    t0 = time.perf_counter()
    route = model.refresh_route(force=force)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    free()
    grown = torch.cuda.memory_allocated() - before
    kept = mirror_bytes(model) - mirrors_before
    check(abs(grown - kept) <= ROUTE_SLACK_BYTES,
          f"{label}: the card grew by {grown} bytes over the route, the "
          f"kept mirrors are {kept}")
    line = check_route(model, label, route, seconds, launches)
    log({"phase": "route_memory", "config": label, "grown_bytes": grown,
         "kept_mirror_bytes": kept})
    return line


def reference_top_n_batch(model, how_many: int, Q: np.ndarray,
                          excl: list[set[str]]):
    """The model's own streaming two-phase top-k (same kind, phase B,
    certificate fallback and decode) with every phase-A kernel swapped
    for its plain version, over the whole request set at once."""
    from oryx_tpu_torch.app.als import serving_model as sm
    vecs, _ = model.Y.device_arrays()
    big, chunk = sm._stream_plan(int(vecs.shape[0]), 8)
    check(big and int(vecs.shape[0]) % chunk == 0,
          "model is on the streaming path")
    fb0 = model.twophase_fallbacks
    with plain_phase_a():
        out = model.top_n_batch(how_many, Q, excl)
    return out, model.twophase_fallbacks - fb0


def exact_top_n(model, how_many: int, Q: np.ndarray, excl):
    """Exact chunked scan, no two-phase selection: the oracle."""
    import torch
    from oryx_tpu_torch.app.als import serving_model as sm
    vecs, active, version = model.Y.device_arrays_versioned()
    n_rows = int(vecs.shape[0])
    k = min(sm._pad_k(max(how_many + len(e) for e in excl)), n_rows)
    _, chunk = sm._stream_plan(n_rows, 8)
    lsh_on = route_lsh(model)
    buckets = model._cached_buckets(vecs, version) if lsh_on else None
    hp = model.lsh._device_hyperplanes() if lsh_on else None
    mb = model.lsh.max_bits_differing if lsh_on else 0
    Qd = torch.from_numpy(np.ascontiguousarray(Q, np.float32)).to(DEVICE)
    ts, ti = sm._batch_top_n_chunked_kernel(vecs, Qd, active, buckets, hp,
                                            k, chunk, mb)
    return model._decode_top_n(ts.cpu().numpy(), ti.cpu().numpy(),
                               [how_many] * len(Q), excl, len(Q),
                               k < n_rows, Q, True)


def same_answers(got, want, rtol: float, what: str) -> None:
    check([i for i, _ in got] == [i for i, _ in want],
          f"{what}: ids {[i for i, _ in got]} != {[i for i, _ in want]}")
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=rtol, err_msg=what)


@contextlib.contextmanager
def static_server(model):
    """The model behind the port's HttpApp + TopNBatcher +
    StaticModelManager (``bench.grid.serve``): yields (port, batcher)."""
    from oryx_tpu_torch.bench.grid import serve
    with serve(model) as (base, batcher):
        yield int(base.rsplit(":", 1)[1]), batcher


def serve_and_check(model, label: str, route: dict, n_recommend: int,
                    n_many: int, n_consider: int, rtol: float,
                    n_exact: int, layer=None, then=None) -> dict:
    """The untimed and the timed round over HTTP, through ``layer``'s
    server and batcher when given, else through ``static_server``; then
    ``then(port)``, on the same server, when given."""
    with (contextlib.nullcontext((layer.port, layer.top_n_batcher))
          if layer is not None else static_server(model)) as (port, batcher):
        summary = serve_rounds(model, label, route, port, batcher,
                               n_recommend, n_many, n_consider, rtol,
                               n_exact)
        if then is not None:
            then(port)
        return summary


def serve_rounds(model, label: str, route: dict, port: int, batcher,
                 n_recommend: int, n_many: int, n_consider: int,
                 rtol: float, n_exact: int) -> dict:
    import torch
    kind = route["chosen"]
    check(routed_kind(model) == kind,
          f"{label}: serves {routed_kind(model)!r}, the route chose {kind!r}")
    expected = next(k for k, v in KERNELS.items() if v[2] == kind)

    requests = [(f"/recommend/u{u}?howMany=10", [f"u{u}"], False)
                for u in range(n_recommend)]
    requests += [(f"/recommendToMany/u{u}/u{u + 1}/u{u + 2}?howMany=10",
                  [f"u{u}", f"u{u + 1}", f"u{u + 2}"], False)
                 for u in range(100, 100 + 3 * n_many, 3)]
    requests += [(f"/recommend/u{u}?howMany=10&considerKnownItems=true",
                  [f"u{u}"], True) for u in range(500, 500 + n_consider)]

    def fetch(path):
        return http_call(port, "GET", path)

    status, _, _ = fetch("/ready")
    check(status == 204, f"{label}: /ready gave {status}")
    with concurrent.futures.ThreadPoolExecutor(32) as pool:
        # one untimed round first: the batcher learns its pacing
        # from completed dispatches, and until then it lets every
        # dispatcher thread take a request of its own
        for path, (status, body, _) in zip(
                [r[0] for r in requests],
                pool.map(fetch, [r[0] for r in requests])):
            check(status == 200, f"{label}: warm-up {path} gave "
                  f"{status}: {body[:300]}")
        torch.cuda.synchronize()
        drains0 = len(batcher.batch_sizes)
        fallbacks0 = model.twophase_fallbacks
        reset_launches()
        t0 = time.perf_counter()
        results = list(pool.map(fetch, [r[0] for r in requests]))
        wall = time.perf_counter() - t0
        launches = read_launches()
        fallbacks = model.twophase_fallbacks - fallbacks0
    sizes = batcher.batch_sizes[drains0:]
    stats = batcher.stats()
    status, _, _ = fetch("/recommend/nobody")
    check(status == 404, f"{label}: unknown user gave {status}")

    for (path, _, _), (status, body, _) in zip(requests, results):
        check(status == 200, f"{label}: {path} gave {status}: {body[:300]}")
    check(launches[expected] > 0,
          f"{label}: {expected} launched no time: {launches}")
    check(all(v == 0 for k, v in launches.items() if k != expected),
          f"{label}: another phase-A kernel than {expected} launched: "
          f"{launches}")

    # the answers the same model gives with every kernel's plain version
    Q, excl = [], []
    for _, users, consider in requests:
        Q.append(np.mean([model.get_user_vector(u) for u in users], axis=0))
        excl.append(set() if consider else
                    set().union(*(model.get_known_items(u) for u in users)))
    Q = np.asarray(Q, np.float32)
    want, ref_fallbacks = reference_top_n_batch(model, 10, Q, excl)
    for (path, _, _), (_, body, _), w in zip(requests, results, want):
        got = [(d["id"], d["value"]) for d in json.loads(body)]
        check(len(got) == 10, f"{label}: {path} gave {len(got)} items")
        check(all(np.isfinite(v) for _, v in got), f"{label}: non-finite")
        same_answers(got, w, rtol, f"{label} {path}")
    exact = exact_top_n(model, 10, Q[:n_exact], excl[:n_exact])
    for w, e in zip(want[:n_exact], exact):
        same_answers(w, e, 1e-5, f"{label} exact scan")

    lat = sorted(r[2] for r in results)
    summary = {"phase": "serve", "config": label, "kind": kind,
               "static_kind": route["static_kind"],
               "use_lsh": route["use_lsh"],
               "requests": len(requests), "concurrency": 32,
               "launches": launches,
               "route_launches": route["launches"],
               "batcher_dispatches": len(sizes),
               "mean_batch": float(np.mean(sizes)),
               "queue_wait_ms": stats["queue_wait_ms"],
               "service_time_ms": stats["service_time_ms"],
               "twophase_fallbacks": fallbacks,
               "reference_fallbacks": ref_fallbacks,
               "qps": len(requests) / wall,
               "p50_ms": lat[len(lat) // 2],
               "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
               "max_ms": lat[-1]}
    log(summary)
    return summary


# -- the fold-in routes and the rest of the ALS surface ----------------------

def http_call(port: int, method: str, path: str, body: bytes | None = None,
              headers: dict | None = None, accept="application/json"):
    """(status, body, milliseconds) of one request on a new connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body,
                     headers={"Accept": accept, **(headers or {})})
        resp = conn.getresponse()
        out = resp.read()
        return resp.status, out, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def route_serve(label: str, route: str, times_ms: list[float],
                **extra) -> dict:
    lat = sorted(times_ms)
    line = {"phase": "route_serve", "config": label, "route": route,
            "requests": len(lat), "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            **extra}
    log(line)
    return line


def gramian64(model) -> np.ndarray:
    """Y^T Y of the model's live item rows, in float64 on the host."""
    host, active, _ = model.Y.host_arrays()
    f = model.features
    g = np.zeros((f, f))
    for s in range(0, host.shape[0], 1 << 22):
        b = host[s:s + (1 << 22), :f].astype(np.float64)
        b[~active[s:s + (1 << 22)]] = 0.0
        g += b.T @ b
    return g


def target_qui(implicit: bool, value: float, current: float) -> float:
    """ALSUtils.computeTargetQui; NaN means no change."""
    if not implicit:
        return value
    if value > 0.0 and current < 1.0:
        return current + (value / (1.0 + value)) * (1.0 - max(0.0, current))
    if value < 0.0 and current > 0.0:
        return current + (value / (value - 1.0)) * (-min(1.0, current))
    return float("nan")


def fold_in_f64(gram: np.ndarray, model, ctx, xu):
    """The reference's context fold-in (als_fold_in.py:101-117, one
    event after another) as a plain host float64 loop over the Gramian."""
    x = None if xu is None else np.asarray(xu, np.float64)
    for item, value in ctx:
        y = model.get_item_vector(item)
        if y is None:
            continue
        y = y.astype(np.float64)
        qui = float(x @ y) if x is not None else 0.0
        target = target_qui(model.implicit, value,
                            qui if x is not None else 0.5)
        if np.isnan(target):
            continue
        d = np.linalg.solve(gram, y * (target - qui))
        x = d if x is None else x + d
    return x


def contexts(rng, n_items: int, n: int) -> list[list[tuple[str, float]]]:
    """``n`` contexts of 1-8 distinct items with strengths (3 decimals,
    so the path spells the value exactly)."""
    out = []
    for _ in range(n):
        m = int(rng.integers(1, MAX_CONTEXT + 1))
        items = rng.choice(n_items, m, replace=False)
        out.append([(f"i{j}", float(f"{rng.uniform(0.2, 3.0):.3f}"))
                    for j in items])
    return out


def context_path(ctx) -> str:
    return "/".join(f"{i}={v}" for i, v in ctx)


def round_paths(ctxs, users) -> list[str]:
    """/recommendToAnonymous where ``users[i]`` is None, else
    /recommendWithContext for that user."""
    return [f"/recommendToAnonymous/{context_path(c)}?howMany=10"
            if u is None else
            f"/recommendWithContext/{u}/{context_path(c)}?howMany=10"
            for c, u in zip(ctxs, users)]


def anonymous_round(model, label: str, port: int, gram: np.ndarray,
                    ctxs, users, rtol: float) -> list[dict]:
    """One timed concurrent round (32 clients) of /recommendToAnonymous
    (``users[i]`` None) and /recommendWithContext.  Each context's vector
    from the port's fold-in on the card is held against the float64 loop,
    elementwise and by the relative norm of its change (the fold-in's own
    contribution); each answer against the model's own top-k of that
    vector with every phase-A kernel swapped for its plain version; only
    the routed kind's kernel may have launched."""
    from oryx_tpu_torch.ops import als_fold_in
    import torch
    kind = routed_kind(model)
    expected = next(k for k, v in KERNELS.items() if v[2] == kind)
    solver = model.get_yty_solver(blocking=True)
    check(solver is not None, f"{label}: no Y^T Y solver")
    paths = round_paths(ctxs, users)
    torch.cuda.synchronize()
    reset_launches()
    with concurrent.futures.ThreadPoolExecutor(32) as pool:
        results = list(pool.map(lambda p: http_call(port, "GET", p), paths))
    launches = read_launches()
    for path, (status, body, _) in zip(paths, results):
        check(status == 200, f"{label}: {path} gave {status}: {body[:300]}")
    check(launches[expected] > 0,
          f"{label}: {expected} launched no time in the fold-in round: "
          f"{launches}")
    check(all(v == 0 for k, v in launches.items() if k != expected),
          f"{label}: another phase-A kernel than {expected} launched in the "
          f"fold-in round: {launches}")
    Q, excl, abs_err, rel_err, fold_ms = [], [], 0.0, 0.0, []
    for ctx, u in zip(ctxs, users):
        xu0 = None if u is None else model.get_user_vector(u)
        # one request's fold-in alone, on an idle card (it ends in a
        # fetch, so the host clock holds its device time)
        t0 = time.perf_counter()
        got = als_fold_in.fold_in_sequential(
            solver, ctx, model.get_item_vector, xu0, model.implicit,
            model.features)
        fold_ms.append((time.perf_counter() - t0) * 1e3)
        want = fold_in_f64(gram, model, ctx, xu0)
        check(got is not None and want is not None,
              f"{label}: a context folded into no vector: {ctx}")
        np.testing.assert_allclose(got, want, rtol=FOLD_RTOL, atol=FOLD_ATOL,
                                   err_msg=f"{label} fold-in {ctx}")
        abs_err = max(abs_err, float(np.max(np.abs(got - want))))
        # the change is small next to FOLD_ATOL (an anonymous vector is
        # all change): hold its relative error too, so a route that
        # ignored or misfolded the context fails
        start = np.zeros_like(want) if xu0 is None else xu0.astype(np.float64)
        rel = float(np.linalg.norm(got.astype(np.float64) - want)
                    / np.linalg.norm(want - start))
        check(rel <= FOLD_RTOL,
              f"{label}: fold-in change's relative error {rel} ({ctx}, {u})")
        rel_err = max(rel_err, rel)
        Q.append(got)
        known = set() if u is None else model.get_known_items(u)
        excl.append(known | {i for i, _ in ctx})
    want_all, _ = reference_top_n_batch(model, 10, np.asarray(Q, np.float32),
                                        excl)
    for path, (_, body, _), w in zip(paths, results, want_all):
        got = [(d["id"], d["value"]) for d in json.loads(body)]
        check(len(got) == 10, f"{label}: {path} gave {len(got)} items")
        same_answers(got, w, rtol, f"{label} {path}")
    out = []
    for route, user_kind in (("/recommendToAnonymous", False),
                             ("/recommendWithContext", True)):
        times = [r[2] for r, u in zip(results, users)
                 if (u is not None) == user_kind]
        if times:
            out.append(route_serve(
                label, route, times, concurrency=32, kind=kind,
                launches=launches, fold_in_max_abs_err=abs_err,
                fold_in_max_rel_err_of_change=rel_err,
                fold_in_alone_p50_ms=statistics.median(fold_ms),
                context_items=sum(len(c) for c in ctxs) / len(ctxs)))
    return out


def traced_round(port: int, paths: list[str], trace_dir: str,
                 label: str) -> dict:
    """``paths`` once more (32 clients) under torch.profiler, after the
    timed round: the operator tables and the Chrome trace go under
    ``trace_dir``; the log line gives the round's wall time, the host's
    time in blocking CUDA calls, the host-to-device copies, and the
    device's busy time (the union of its kernel and copy intervals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            results = list(pool.map(lambda p: http_call(port, "GET", p),
                                    paths))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for path, (status, body, _) in zip(paths, results):
        check(status == 200, f"{label}: traced {path} gave {status}")
    avg = prof.key_averages()
    for sort in ("self_cpu_time_total", "self_device_time_total"):
        try:
            table = avg.table(sort_by=sort, row_limit=50)
        except (AttributeError, KeyError):
            table = avg.table(sort_by="self_cuda_time_total", row_limit=50)
        with open(os.path.join(trace_dir, f"fold_in_round_{sort}.txt"), "w",
                  encoding="utf-8") as f:
            f.write(table)
    prof.export_chrome_trace(os.path.join(trace_dir, "fold_in_round.json"))
    blocking = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
                "cudaMemcpyAsync", "cudaMemcpy", "cudaEventSynchronize"}
    host = {e.key: (e.count, e.self_cpu_time_total / 1e3) for e in avg
            if e.key in blocking}
    copies = {e.key: e.count for e in avg if e.key.startswith("Memcpy")}
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    line = {"phase": "trace", "config": label, "requests": len(paths),
            "wall_ms": wall_ms,
            "p50_ms": statistics.median(r[2] for r in results),
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "blocking_host_calls": {k: {"count": c, "host_ms": ms}
                                    for k, (c, ms) in host.items()},
            "copies": copies, "files": trace_dir}
    log(line)
    return line


def lsh_eligible(model, q: np.ndarray, active: np.ndarray) -> np.ndarray:
    """The rows a flat top-N of query ``q`` considers: live, and under an
    LSH route within the Hamming ball of q's bucket (the model's item
    buckets; the query's bucket and the ball in NumPy)."""
    if not (route_lsh(model) and model.lsh.num_hashes > 0):
        return active
    vecs, _, version = model.Y.device_arrays_versioned()
    buckets = model._cached_buckets(vecs, version).cpu().numpy()
    signs = (model.lsh.hyperplanes @ q.astype(np.float32)) > 0
    target = int(sum(1 << i for i, s in enumerate(signs) if s))
    diff = np.bitwise_xor(buckets, np.int32(target)).view(np.uint32)
    ones = np.unpackbits(diff.view(np.uint8)).reshape(-1, 32).sum(axis=1)
    return active & (ones <= model.lsh.max_bits_differing)


def held_top_n(got, scores: np.ndarray, eligible: np.ndarray, row_of,
               n: int, what: str, rtol: float = 1e-4) -> None:
    """``got`` is an exact top-n of ``scores`` over ``eligible`` rows, up
    to ties: each score matches its row's, the list descends, it is n long
    (or every eligible row), and no row left out scores above the lowest
    returned by more than the tolerance."""
    check(len(got) == min(n, int(eligible.sum())),
          f"{what}: {len(got)} results")
    rows = [row_of(i) for i, _ in got]
    check(None not in rows and all(eligible[r] for r in rows),
          f"{what}: a result is not an eligible row")
    np.testing.assert_allclose([v for _, v in got], scores[rows], rtol=rtol,
                               atol=1e-6, err_msg=what)
    vals = [v for _, v in got]
    check(all(a >= b for a, b in zip(vals, vals[1:])), f"{what}: not sorted")
    rest = eligible.copy()
    rest[rows] = False
    if rest.any() and rows:
        best_left = float(scores[rest].max())
        low = float(min(scores[rows]))
        check(best_left <= low + rtol * abs(low) + 1e-6,
              f"{what}: a row scoring {best_left} was left out below {low}")


def surface_checks(model, label: str, port: int, known: dict,
                   rng) -> list[dict]:
    """Every other ALS read route of phase 4, a few requests each, held
    against plain NumPy on the model's own arrays."""
    host, active, row_ids = model.Y.host_arrays()
    f = model.features
    Yh = host[:, :f].astype(np.float64)
    y_norm = np.linalg.norm(Yh, axis=1)
    row_of = model.Y.row_of
    n_items = len(model.Y)
    lines = []

    def get(path, accept="application/json"):
        status, body, ms = http_call(port, "GET", path, accept=accept)
        check(status == 200, f"{label}: {path} gave {status}: {body[:300]}")
        return json.loads(body), ms

    def pairs(body):
        return [(d["id"], d["value"]) for d in body]

    def close(got, want, what, atol):
        """Equal ids, values within rtol 1e-4 and ``atol`` (the float32
        round-off of a sum of ``features`` products)."""
        check([i for i, _ in got] == [i for i, _ in want],
              f"{what}: ids {[i for i, _ in got]} != {[i for i, _ in want]}")
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                                   rtol=1e-4, atol=atol, err_msg=what)

    # /similarity: mean-cosine top-N, 2 and 5 items
    times = []
    for j in range(N_SURFACE):
        ids = [f"i{k}" for k in rng.choice(n_items, 2 if j % 2 else 5,
                                           replace=False)]
        body, ms = get(f"/similarity/{'/'.join(ids)}?howMany=10")
        times.append(ms)
        V = np.stack([model.get_item_vector(i) for i in ids], axis=1)
        V = V.astype(np.float64)
        cos = (Yh @ V) / np.maximum(
            y_norm[:, None] * np.linalg.norm(V, axis=0)[None, :], 1e-12)
        elig = lsh_eligible(model, V.mean(axis=1), active.copy())
        elig[[row_of(i) for i in ids]] = False
        held_top_n(pairs(body), cos.mean(axis=1), elig, row_of, 10,
                   f"{label} /similarity/{ids}")
    lines.append(route_serve(label, "/similarity", times))

    # /similarityToItem, /estimate, /because, /mostSurprising
    times = {r: [] for r in ("/similarityToItem", "/estimate", "/because",
                             "/mostSurprising", "/estimateForAnonymous")}
    gram = gramian64(model)
    for j in range(N_SURFACE):
        u = f"u{int(rng.integers(0, N_USERS))}"
        xu = model.get_user_vector(u).astype(np.float64)
        kn = sorted(known[u])
        to, ids = f"i{int(rng.integers(0, n_items))}", \
            [f"i{k}" for k in rng.choice(n_items, 4, replace=False)]
        to_v = model.get_item_vector(to).astype(np.float64)
        body, ms = get(f"/similarityToItem/{to}/{'/'.join(ids)}")
        times["/similarityToItem"].append(ms)
        want = [(i, float(model.get_item_vector(i) @ to_v
                          / (np.linalg.norm(model.get_item_vector(i))
                             * np.linalg.norm(to_v)))) for i in ids]
        close(pairs(body), want, f"{label} /similarityToItem", 1e-6)
        body, ms = get(f"/estimate/{u}/{'/'.join(ids)}/nope")
        times["/estimate"].append(ms)
        want = [(i, float(xu @ model.get_item_vector(i))) for i in ids]
        close(pairs(body), want + [("nope", 0.0)], f"{label} /estimate",
              1e-4)
        body, ms = get(f"/because/{u}/{to}?howMany=20")
        times["/because"].append(ms)
        sims = sorted(((i, float(model.get_item_vector(i) @ to_v
                                 / (np.linalg.norm(model.get_item_vector(i))
                                    * np.linalg.norm(to_v)))) for i in kn),
                      key=lambda t: -t[1])
        close(pairs(body), sims, f"{label} /because", 1e-6)
        body, ms = get(f"/mostSurprising/{u}?howMany=20")
        times["/mostSurprising"].append(ms)
        dots = sorted(((i, float(xu @ model.get_item_vector(i)))
                       for i in kn), key=lambda t: t[1])
        close(pairs(body), dots, f"{label} /mostSurprising", 1e-4)
        ctx = contexts(rng, n_items, 1)[0]
        body, ms = get(f"/estimateForAnonymous/{to}/{context_path(ctx)}")
        times["/estimateForAnonymous"].append(ms)
        xa = fold_in_f64(gram, model, ctx, None)
        # the context vector is small: its error bound, not FOLD_ATOL,
        # scales the tolerance
        np.testing.assert_allclose(
            body, float(xa @ to_v), rtol=FOLD_RTOL,
            atol=FOLD_RTOL * float(np.linalg.norm(xa) * np.linalg.norm(to_v)),
            err_msg=f"{label} /estimateForAnonymous")
    lines += [route_serve(label, r, t) for r, t in times.items()]

    # /mostActiveUsers, /mostPopularItems: counts from the UP records
    user_counts = {u: len(set(items)) for u, items in known.items() if items}
    item_counts: dict[str, int] = {}
    for items in known.values():
        for i in set(items):
            item_counts[i] = item_counts.get(i, 0) + 1
    for route, want in (("/mostActiveUsers", user_counts),
                        ("/mostPopularItems", item_counts)):
        times = []
        for _ in range(N_SURFACE):
            body, ms = get(f"{route}?howMany=50")
            times.append(ms)
            got = [(d["id"], d["count"]) for d in body]
            check([c for _, c in got]
                  == sorted(want.values(), reverse=True)[:50],
                  f"{label} {route}: counts {got[:5]}")
            check(all(want.get(i) == c for i, c in got),
                  f"{label} {route}: an id's count differs")
        lines.append(route_serve(label, route, times))

    # /popularRepresentativeItems: the top item along each feature axis
    times = []
    for _ in range(2):
        body, ms = get("/popularRepresentativeItems")
        times.append(ms)
        check(len(body) == f, f"{label}: {len(body)} representatives")
        for k, item in enumerate(body):
            unit = np.zeros(f)
            unit[k] = 1.0
            elig = lsh_eligible(model, unit, active.copy())
            held_top_n([(item, float(Yh[row_of(item), k]))], Yh[:, k], elig,
                       row_of, 1, f"{label} representative {k}")
    lines.append(route_serve(label, "/popularRepresentativeItems", times))

    for route, want in (("/user/allIDs", {f"u{u}" for u in range(N_USERS)}),
                        ("/item/allIDs", {i for i in row_ids if i})):
        body, ms = get(route)
        check(len(body) == len(want) and set(body) == want,
              f"{label} {route}: {len(body)} ids")
        lines.append(route_serve(label, route, [ms]))
    return lines


def write_path_checks(label: str, port: int, broker_dir: str,
                      topic: str) -> list[dict]:
    """POST and DELETE /pref and /ingest (plain, gzip, zip, multipart)
    through the layer, then the input topic read back from its file://
    log: every line exactly once, with the reference's key, in the
    partition ``partition_for_key`` gives; a body with one bad line
    answers 400 and appends nothing."""
    import gzip
    import io
    import zipfile
    import zlib
    from oryx_tpu_torch.kafka.partitioner import partition_for_key

    def log_records():
        with open(os.path.join(broker_dir, f"{topic}.meta.json")) as fh:
            n = json.load(fh)["partitions"]
        out = []
        for p in range(n):
            name = f"{topic}.topic.jsonl" if p == 0 else \
                f"{topic}.p{p}.topic.jsonl"
            path = os.path.join(broker_dir, name)
            with open(path, encoding="utf-8") as fh:
                out.append([json.loads(line) for line in fh if line.strip()])
        return out

    zbuf = io.BytesIO()
    with zipfile.ZipFile(zbuf, "w") as zf:
        zf.writestr("a.csv", "z1,zi1,1\nz2,zi2,2\n")
    mp = (b"--b0\r\nContent-Disposition: form-data; name=\"a\"; "
          b"filename=\"a.csv\"\r\nContent-Type: text/csv\r\n\r\n"
          b"m1,mi1,1\r\n--b0\r\nContent-Disposition: form-data; "
          b"name=\"b\"; filename=\"b.csv.gz\"\r\nContent-Type: "
          b"application/octet-stream\r\nContent-Transfer-Encoding: "
          b"binary\r\n\r\n" + gzip.compress(b"m2,mi2,2\n")
          + b"\r\n--b0--\r\n")
    writes = [
        ("POST /pref", "POST", "/pref/u1/i2", b"2.5", {}, ["u1,i2,2.5"]),
        ("POST /pref", "POST", "/pref/u3/i4", b"", {}, ["u3,i4,1"]),
        ("DELETE /pref", "DELETE", "/pref/u5/i6", None, {}, ["u5,i6,"]),
        ("/ingest plain", "POST", "/ingest", b"p1,pi1,1\np2,pi2,2.0,17\n",
         {"Content-Type": "text/csv"}, ["p1,pi1,1", "p2,pi2,2.0,17"]),
        ("/ingest gzip", "POST", "/ingest",
         gzip.compress(b"g1,gi1,1\ng2,gi2,3\n"),
         {"Content-Encoding": "gzip"}, ["g1,gi1,1", "g2,gi2,3"]),
        ("/ingest zip", "POST", "/ingest", zbuf.getvalue(),
         {"Content-Type": "application/zip"}, ["z1,zi1,1", "z2,zi2,2"]),
        ("/ingest multipart", "POST", "/ingest", mp,
         {"Content-Type": "multipart/form-data; boundary=b0"},
         ["m1,mi1,1", "m2,mi2,2"]),
    ]
    before = log_records()
    times: dict[str, list[float]] = {}
    expected = []
    for name, method, path, body, headers, lines in writes:
        status, out, ms = http_call(port, method, path, body, headers)
        check(status in (200, 204), f"{label}: {name} gave {status}: "
              f"{out[:300]}")
        times.setdefault(name, []).append(ms)
        expected += lines
    after = log_records()
    added = [recs[len(old):] for old, recs in zip(before, after)]
    got = []
    for p, recs in enumerate(added):
        for key, message, headers in recs:
            check(key == format(zlib.crc32(message.encode()), "x"),
                  f"{label}: key {key} of {message!r}")
            check(partition_for_key(key, len(added)) == p,
                  f"{label}: {message!r} in partition {p}")
            check(set(headers) == {"ts"}, f"{label}: headers {headers}")
            got.append(message)
    check(sorted(got) == sorted(expected),
          f"{label}: the input topic holds {sorted(got)}, expected "
          f"{sorted(expected)}")
    status, _, ms = http_call(port, "POST", "/ingest",
                              b"b1,bi1,1\nnot-a-record\n")
    check(status == 400, f"{label}: a bad /ingest line gave {status}")
    check(log_records() == after, f"{label}: a refused /ingest appended")
    times["/ingest bad line"] = [ms]
    return [route_serve(label, name, t) for name, t in times.items()]


def window_times(model, rng, label: str, kind: str) -> list[dict]:
    """One served window at each ladder size: ``top_n_batch`` end to
    end (host clock around a synchronised call), and its phase A
    (kernel), phase B and, for the int8 kinds, the bound epilogue alone
    (CUDA events) on the same queries, each timed as
    ``bench/kernel_probe.kind_program`` builds it."""
    import torch
    from oryx_tpu_torch.bench.kernel_probe import kind_program
    out = []
    for b in WINDOWS:
        q = rng.standard_normal((b, model.features), dtype=np.float32)
        fb0 = model.twophase_fallbacks

        def served():
            model.top_n_batch(10, q)
            torch.cuda.synchronize()

        for _ in range(2):
            served()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            served()
            walls.append((time.perf_counter() - t0) * 1e3)
        run_a, run_b, run_e = kind_program(model, kind,
                                           torch.from_numpy(q).to(DEVICE))
        row = {"phase": "window", "config": label, "kind": kind, "B": b,
               "top_n_batch_ms": statistics.median(walls),
               "phase_a_ms": time_ms(torch, run_a),
               "phase_b_ms": time_ms(torch, run_b),
               **({"epilogue_ms": time_ms(torch, run_e)} if run_e else {}),
               "fallback_rows": model.twophase_fallbacks - fb0}
        log(row)
        out.append(row)
    return out


def serve_config(features, Y, X, known, label: str, kind: str, dtype,
                 sample_rate, int8_selection, counts, rng, y_ids=None,
                 anonymous: bool = False, model=None):
    """Build, route and serve one configuration; with ``anonymous``, a
    timed round of /recommendToAnonymous follows the rounds, its solver
    and float64 Gramian computed before it.  With ``model`` (the loaded
    model of the configuration before, the same vectors), that model
    serves with this configuration's int8 selection, routed anew."""
    if model is None:
        model = build_model(features, Y, X, known, dtype, sample_rate,
                            int8_selection, y_ids)
        route = routed_config(model, label, kind)
    else:
        model._int8_selection = int8_selection
        log({"phase": "model", "config": label, "shared": True,
             "int8_selection": int8_selection, "load_s": 0.0})
        route = routed_config(model, label, kind, force=True)
    window_times(model, rng, label, route["chosen"])
    then = None
    if anonymous:
        check(model.get_yty_solver(blocking=True) is not None,
              f"{label}: no Y^T Y solver")
        gram = gramian64(model)
        ctxs = contexts(np.random.default_rng(CONTEXT_SEED), len(Y), 32)

        def then(port):
            anonymous_round(model, label, port, gram, ctxs, [None] * 32,
                            RTOL[dtype])
    summary = serve_and_check(model, label, route, *counts, RTOL[dtype],
                              counts[0] // 8, then=then)
    return model, summary


def routed_config(model, label: str, kind: str,
                  force: bool = False) -> dict:
    """Route the model and check that its static first kind is the
    configuration's."""
    route = route_model(model, label, force)
    check(route["static_kind"] == kind,
          f"{label}: static first kind {route['static_kind']!r}, expected "
          f"{kind!r}")
    return route


# -- phase 4: serve off the update topic -------------------------------------

def topic_data(seed: int):
    """(Y, X, known items) of the update-topic configuration."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((N_TOPIC_ITEMS, TOPIC_FEATURES), dtype=np.float32)
    X = rng.standard_normal((N_USERS, TOPIC_FEATURES), dtype=np.float32)
    X[:SMALL_USERS] *= np.float32(SMALL_USER_SCALE)
    known = {f"u{u}": sorted({f"i{j}" for j in rng.integers(
        0, N_TOPIC_ITEMS, KNOWN_PER_USER)}) for u in range(N_USERS)}
    return Y, X, known


def publish_topic_model(model_dir: str, seed: int) -> None:
    """Write the model directory a MODEL-REF names: the PMML document
    and the sliced artifacts.  Runs in a child process while the card
    works on phases 2-3; touches no card."""
    from oryx_tpu_torch.app.als import slices
    from oryx_tpu_torch.common import pmml as pmml_io
    t0 = time.perf_counter()
    Y, X, known = topic_data(seed)
    y_ids = [f"i{j}" for j in range(N_TOPIC_ITEMS)]
    x_ids = [f"u{u}" for u in range(N_USERS)]
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", TOPIC_FEATURES)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", x_ids)
    pmml_io.add_extension_content(doc, "YIDs", y_ids)
    pmml_io.write(doc, os.path.join(model_dir, "model.pmml.xml"))
    slim = slices.publish_sliced(model_dir, y_ids, Y, x_ids, X, known,
                                 TOPIC_RING)
    with open(os.path.join(model_dir, "published.json"), "w",
              encoding="utf-8") as f:
        json.dump({"manifest": slim,
                   "seconds": time.perf_counter() - t0}, f)


def wait_for(cond, what: str, timeout: float) -> None:
    deadline = time.perf_counter() + timeout
    while not cond():
        check(time.perf_counter() < deadline, f"timed out waiting for {what}")
        time.sleep(0.05)


def serve_update_topic(publisher, work_dir: str, rng,
                       trace_dir: str | None) -> dict:
    """Phase 4: a ServingLayer from the port's example config replays
    a MODEL-REF and the users' UP records from a file:// update topic,
    measures its route, and serves the rounds of phase 3; with
    ``trace_dir``, one more fold-in round runs under torch.profiler."""
    import torch
    from oryx_tpu_torch.app.als import kernel_router, slices
    from oryx_tpu_torch.common.config import from_file, overlay_on
    from oryx_tpu_torch.kafka.inproc import InProcTopicProducer
    from oryx_tpu_torch.lambda_rt.serving import ServingLayer

    label = "1M_50f_f32_lsh0.3_topic"
    model_dir = os.path.join(work_dir, "model")
    t_wait = time.perf_counter()
    publisher.join(TOPIC_WAIT_S)
    check(publisher.exitcode == 0,
          f"{label}: publishing the model failed ({publisher.exitcode})")
    with open(os.path.join(model_dir, "published.json"),
              encoding="utf-8") as f:
        published = json.load(f)
    log({"phase": "publish", "config": label, "items": N_TOPIC_ITEMS,
         "features": TOPIC_FEATURES, "ring": TOPIC_RING,
         "seconds": published["seconds"],
         "waited_s": time.perf_counter() - t_wait,
         "slice_bytes": sum(e["bytes"]
                            for e in published["manifest"]["slices"])})
    _, X, known = topic_data(TOPIC_SEED)
    broker = "file://" + os.path.join(work_dir, "broker")
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "oryx_tpu_torch", "conf", "als-example.conf")
    cfg = overlay_on({"oryx.update-topic.broker": broker,
                      "oryx.input-topic.broker": broker,
                      "oryx.als.sample-rate": LSH_RATE}, from_file(conf))

    measured = []
    real_measure = kernel_router.measure_routes

    def timed_measure(model, *args, **kwargs):
        before = read_launches()
        t0 = time.perf_counter()
        route = real_measure(model, *args, **kwargs)
        torch.cuda.synchronize()
        measured.append((route, time.perf_counter() - t0,
                         {k: v - before[k]
                          for k, v in read_launches().items()}))
        return route

    free()
    baseline = torch.cuda.memory_allocated()
    kernel_router.measure_routes = timed_measure
    layer = ServingLayer(cfg, port=0)
    try:
        layer.start()
        mgr = layer.model_manager
        producer = InProcTopicProducer(
            broker, cfg.get_string("oryx.update-topic.message.topic"))
        reset_launches()
        t0 = time.perf_counter()
        producer.send("MODEL-REF", slices.model_ref_message(
            os.path.join(model_dir, "model.pmml.xml"), model_dir,
            published["manifest"]))
        for u in range(N_USERS):
            producer.send("UP", json.dumps(
                ["X", f"u{u}", [float(v) for v in X[u]], known[f"u{u}"]]))

        def ready() -> bool:
            conn = http.client.HTTPConnection("127.0.0.1", layer.port,
                                              timeout=60)
            try:
                conn.request("GET", "/ready")
                resp = conn.getresponse()
                resp.read()
                return resp.status == 204
            finally:
                conn.close()

        wait_for(ready, f"{label}: /ready", TOPIC_WAIT_S)
        ready_s = time.perf_counter() - t0
        model = mgr.get_model()
        last = f"u{N_USERS - 1}"
        wait_for(lambda: model._route is not None
                 and np.array_equal(model.get_user_vector(last), X[-1])
                 and model.get_known_items(last) == set(known[last]),
                 f"{label}: the route and the UP records", TOPIC_WAIT_S)
        load_s = time.perf_counter() - t0
        # the manager computes both Gramian solvers on threads of their
        # own at load; a failed one leaves its cache without a solver
        solvers = (model.get_xtx_solver(), model.get_yty_solver())
        check(None not in solvers, f"{label}: a Gramian solver is missing "
              f"after the load: {solvers}")
        check(mgr.model_load_s > 0, f"{label}: model_load_s not set")
        check(mgr.slice_loads == TOPIC_RING,
              f"{label}: {mgr.slice_loads} slice loads")
        check(mgr.slice_load_fallbacks == 0,
              f"{label}: {mgr.slice_load_fallbacks} slice load fallbacks")
        check(mgr.rejected_updates == 0 and mgr.rejected_models == 0,
              f"{label}: rejected {mgr.rejected_updates} updates, "
              f"{mgr.rejected_models} models")
        check(len(model.Y) == N_TOPIC_ITEMS and len(model.X) == N_USERS,
              f"{label}: {len(model.Y)} items, {len(model.X)} users")
        routes = [m for m in measured if m[0] is not None]
        check(len(routes) == 1, f"{label}: {len(routes)} routes measured")
        route, seconds, route_launches = routes[0]
        check(model._route is route, f"{label}: the route is not installed")
        torch.cuda.synchronize()
        free()
        held = torch.cuda.memory_allocated() - baseline
        kept = model_bytes(model, solvers)
        check(abs(held - kept) <= ROUTE_SLACK_BYTES,
              f"{label}: the card holds {held} bytes for the model, its "
              f"store, mirrors, buckets and solvers are {kept}")
        line = check_route(model, label, route, seconds, route_launches)
        log({"phase": "topic", "config": label, "load_s": load_s,
             "ready_s": ready_s, "model_load_s": mgr.model_load_s,
             "slice_loads": mgr.slice_loads,
             "slice_load_fallbacks": mgr.slice_load_fallbacks,
             "held_bytes": held, "model_bytes": kept,
             "rows": len(model.Y.row_ids())})
        window_times(model, rng, label, line["chosen"])
        summary = serve_and_check(model, label, line, 32, 4, 4,
                                  RTOL["float32"], 4, layer=layer)
        # the fold-in routes, every other read route, and the write path
        check(layer.input_producer is not None,
              f"{label}: the layer has no input producer")
        ctx_rng = np.random.default_rng(CONTEXT_SEED)
        ctxs = contexts(ctx_rng, N_TOPIC_ITEMS, 32)
        users = [None if j % 2 == 0 else
                 f"u{int(ctx_rng.integers(0, SMALL_USERS))}"
                 for j in range(32)]
        anonymous_round(model, label, layer.port, gramian64(model), ctxs,
                        users, RTOL["float32"])
        if trace_dir:
            traced_round(layer.port, round_paths(ctxs, users), trace_dir,
                         label)
        surface_checks(model, label, layer.port, known, ctx_rng)
        write_path_checks(label, layer.port, broker[len("file://"):],
                          cfg.get_string("oryx.input-topic.message.topic"))
    finally:
        kernel_router.measure_routes = real_measure
        layer.close()
    check(not layer.consuming, f"{label}: the consumer outlived close()")
    return summary


# -- phase 5: the batch and speed layers, and the lambda loop -----------------

def loop_config(work_dir: str):
    """Phase 5b's config: the port's example config on a file:// broker
    and directories under ``work_dir``, rank 100, 3 sweeps, 8 slices."""
    from oryx_tpu_torch.common.config import from_file, overlay_on
    loop = os.path.join(work_dir, "loop")
    broker = "file://" + os.path.join(loop, "broker")
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "oryx_tpu_torch", "conf", "als-example.conf")
    return overlay_on({
        "oryx.input-topic.broker": broker,
        "oryx.update-topic.broker": broker,
        "oryx.batch.storage.data-dir": os.path.join(loop, "data"),
        "oryx.batch.storage.model-dir": os.path.join(loop, "model"),
        "oryx.als.hyperparams.features": TRAIN_RANK,
        "oryx.als.iterations": TRAIN_SWEEPS,
        "oryx.als.publish.slices": LOOP_SLICES,
        "oryx.update-topic.message.max-size": LOOP_MAX_MESSAGE,
        # the run drives the micro-batch itself
        "oryx.speed.streaming.generation-interval-sec": 3600,
        # the batch and speed layers' side doors, and tracing on every
        # layer: only a request that arrives sampled is sampled
        "oryx.obs.metrics-port": 0,
        "oryx.obs.tracing.enabled": True,
        "oryx.obs.tracing.sample-ratio": 0.0,
    }, from_file(conf))


def lambda_data(work_dir: str, ml20m: bool = True) -> None:
    """Phase 5's data, made in a child process while the card works on
    phases 2-4; touches no card.  The MovieLens-20M-shaped interactions
    5a trains on go to ``ml20m.npz`` (unless ``ml20m`` is false: phase
    14 alone trains no 5a); 250,000 more drawn interactions over half
    its users and all its items go onto 5b's input topic as
    ``u,i,strength,ts`` lines, timestamps in random order (so the
    generation's time split holds out a random tenth)."""
    from oryx_tpu_torch.bench.train import synthesize_movielens
    from oryx_tpu_torch.kafka import utils as kafka_utils
    from oryx_tpu_torch.kafka.inproc import InProcTopicProducer
    t0 = time.perf_counter()
    ml20m_pairs = 0
    if ml20m:
        users, items, values, _, _ = synthesize_movielens(
            ML_USERS, ML_ITEMS, ML_RATINGS, seed=TRAIN_SEED)
        np.savez(os.path.join(work_dir, "ml20m.npz"), users=users,
                 items=items, values=values)
        ml20m_pairs = int(users.shape[0])
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = loop_config(work_dir)
    broker = cfg.get_string("oryx.input-topic.broker")
    topic = cfg.get_string("oryx.input-topic.message.topic")
    users, items, values, _, _ = synthesize_movielens(
        LOOP_USERS, ML_ITEMS, LOOP_RATINGS, seed=LOOP_SEED)
    ts = LOOP_T0 + np.random.default_rng(LOOP_SEED).permutation(
        len(users)).astype(np.int64) * 1000
    kafka_utils.maybe_create_topic(
        broker, topic, partitions=kafka_utils.input_topic_partitions(cfg))
    producer = InProcTopicProducer(broker, topic)
    chunk = 100_000
    for s in range(0, len(users), chunk):
        producer.send_many([
            (None, f"u{u},i{i},{v:g},{t}", None) for u, i, v, t in zip(
                users[s:s + chunk].tolist(), items[s:s + chunk].tolist(),
                values[s:s + chunk].tolist(), ts[s:s + chunk].tolist())])
    with open(os.path.join(work_dir, "lambda_data.json"), "w",
              encoding="utf-8") as f:
        json.dump({"ml20m_pairs": ml20m_pairs, "synth_s": synth_s,
            "loop_lines": len(users),
            "loop_write_s": time.perf_counter() - t0}, f)


def row_errors(rows, cols, vals, n_rows: int, opposite: np.ndarray,
               got: np.ndarray, lam: float, alpha: float, rng) -> dict:
    """The relative error, on each row's norm, of ``got`` against a
    float64 host solve of that row's implicit normal equations from the
    same opposite factors, for ROW_CHECKS sampled rows with
    interactions: A = Y^T Y + Y_u^T diag(alpha |r|) Y_u + lambda n_u I,
    b = Y_u^T ((1 + alpha |r|) [r > 0])."""
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=n_rows)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    picks = rng.choice(np.nonzero(counts)[0], ROW_CHECKS, replace=False)
    opp = opposite.astype(np.float64)
    gram = opp.T @ opp
    eye = np.eye(opp.shape[1])
    errs = []
    for r in picks:
        idx = order[ptr[r]:ptr[r + 1]]
        yg = opp[cols[idx]]
        v = vals[idx].astype(np.float64)
        w = alpha * np.abs(v)
        a = gram + (yg * w[:, None]).T @ yg + lam * len(idx) * eye
        x = np.linalg.solve(a, yg.T @ ((1.0 + w) * (v > 0)))
        errs.append(float(np.linalg.norm(got[r] - x) / np.linalg.norm(x)))
    return {"rows": len(picks), "max": max(errs),
            "median": float(np.median(errs)),
            "degrees": [int(counts[picks].min()), int(counts[picks].max())]}


def train_at_scale(work_dir: str, lam: float, alpha: float) -> dict:
    """Phase 5a: ALS on the card at MovieLens-20M's shape and rank 100,
    the 5 % hold-out of the reference bench; the ``train`` line."""
    import torch
    from oryx_tpu_torch.app.als.common import ParsedRatings
    from oryx_tpu_torch.app.als.evaluation import area_under_curve
    from oryx_tpu_torch.app.als.trainer import train_als
    from oryx_tpu_torch.bench.train import _split
    data = np.load(os.path.join(work_dir, "ml20m.npz"))
    users, items, values = data["users"], data["items"], data["values"]
    rng = np.random.default_rng(TRAIN_SEED + 1)
    train_mask, test_mask = _split(rng, len(users), TEST_FRACTION)
    tu, ti, tv = users[train_mask], items[train_mask], values[train_mask]
    ratings = ParsedRatings([str(u) for u in range(ML_USERS)],
                            [str(i) for i in range(ML_ITEMS)], tu, ti, tv)
    free()
    cuda = DEVICE == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    before_last: dict = {}

    def on_iteration(i, X, Y):
        if i == TRAIN_SWEEPS - 2:
            before_last["Y"] = Y

    t0 = time.perf_counter()
    model = train_als(ratings, TRAIN_RANK, lam, alpha, True, TRAIN_SWEEPS,
                      seed=TRAIN_SEED, on_iteration=on_iteration,
                      device=DEVICE, timings=timings)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    check(model.rescue is None, f"train: a rescue rung was taken: "
          f"{model.rescue}")
    check(bool(np.all(np.isfinite(model.X)) and np.all(np.isfinite(model.Y))),
          "train: non-finite factors")
    check(len(timings["sweep_s"]) == TRAIN_SWEEPS, "train: sweeps missing")
    # the last half-sweeps against float64 solves of the same systems:
    # X from the Y before it, Y from that X
    t0 = time.perf_counter()
    row_rng = np.random.default_rng(TRAIN_SEED + 2)
    errs = {"X": row_errors(tu, ti, tv, ML_USERS, before_last["Y"], model.X,
                            lam, alpha, row_rng),
            "Y": row_errors(ti, tu, tv, ML_ITEMS, model.X, model.Y, lam,
                            alpha, row_rng)}
    row_s = time.perf_counter() - t0
    for side, e in errs.items():
        check(e["max"] <= ROW_RTOL, f"train: a sampled {side} row is "
              f"{e['max']} from its float64 solve (limit {ROW_RTOL})")
    # held-out AUC over the reference bench's sample of warm test users
    seen_u = np.zeros(ML_USERS, bool)
    seen_i = np.zeros(ML_ITEMS, bool)
    seen_u[tu] = True
    seen_i[ti] = True
    warm = test_mask & seen_u[users] & seen_i[items]
    eu, ei = users[warm], items[warm]
    chosen = rng.choice(np.unique(eu), AUC_USERS, replace=False)
    keep = np.isin(eu, chosen)
    t0 = time.perf_counter()
    auc = area_under_curve(model.X, model.Y, eu[keep], ei[keep],
                           device=DEVICE)
    auc_s = time.perf_counter() - t0
    check(auc > AUC_LEARNED, f"train: held-out AUC {auc} <= {AUC_LEARNED}")
    sweeps = timings["sweep_s"]
    line = {"phase": "train", "users": ML_USERS, "items": ML_ITEMS,
            "drawn": ML_RATINGS, "pairs": int(len(users)),
            "train_pairs": int(len(tu)), "rank": TRAIN_RANK, "lambda": lam,
            "alpha": alpha, "sweeps": TRAIN_SWEEPS,
            "untimed_sweep_s": sweeps[0], "sweep_s": sweeps[1:],
            "epoch_s": statistics.mean(sweeps[1:]),
            "half_sweep_s": timings["half_sweep_s"],
            "products_s": timings["products_s"],
            "solve_s": timings["solve_s"], "pack_s": timings["pack_s"],
            "train_s": train_s, "peak_bytes": peak,
            "row_rel_err": errs, "row_check_s": row_s,
            "auc": auc, "auc_users": AUC_USERS,
            "auc_pairs": int(keep.sum()), "auc_s": auc_s,
            "rescue": model.rescue}
    log(line)
    return line


def post_prefs(port: int, events, first_headers=None) -> float:
    """POST each (user, item, strength) to /pref on one kept-alive
    connection, the first with ``first_headers``; returns the host clock
    after the last answer."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        for j, (user, item, value) in enumerate(events):
            conn.request("POST", f"/pref/{user}/{item}",
                         body=f"{value}".encode(),
                         headers=(first_headers or {}) if j == 0 else {})
            resp = conn.getresponse()
            resp.read()
            check(resp.status == 204, f"lambda: /pref/{user}/{item} "
                  f"answered {resp.status}")
        return time.perf_counter()
    finally:
        conn.close()


def expected_ups(new_data, snap: dict, implicit: bool) -> dict:
    """The reference's micro-batch (ALSSpeedModelManager.buildUpdates,
    app/als/speed.py:191-246) as a plain host float64 loop: events summed
    per (user, item), then each pair's user vector folded against the
    float64 Y^T Y and its item vector against X^T X, from the speed
    model's vectors before the batch.  Keyed (kind, id, other id)."""
    sums: dict = {}
    for km in new_data:
        user, item, value = km.message.split(",")[:3]
        sums[(user, item)] = sums.get((user, item), 0.0) + float(value)
    out = {}
    for (user, item), value in sums.items():
        value = float(np.float32(value))
        xu = snap["X"].get(user)
        yi = snap["Y"].get(item)
        for kind, vec, other, gram, key in (
                ("X", xu, yi, snap["YtY"], (user, item)),
                ("Y", yi, xu, snap["XtX"], (item, user))):
            if other is None:
                continue
            qui = float(vec @ other) if vec is not None else 0.0
            target = target_qui(implicit, value,
                                qui if vec is not None else 0.5)
            if np.isnan(target):
                continue
            d = np.linalg.solve(gram, other * (target - qui))
            out[(kind, *key)] = d if vec is None else vec + d
    return out


def pref_events(x_ids: list, y_ids: list) -> tuple:
    """(the rng, then drawn on, the users, the ``PREF_EVENTS`` (user,
    item, strength) events) of phase 5b's /pref round, over the
    generation's ids; phase 14 sends the same events."""
    rng = np.random.default_rng(LOOP_SEED + 1)
    pref_users = [x_ids[j] for j in rng.choice(len(x_ids), PREF_USERS,
                                               replace=False)]
    events = [(pref_users[j % PREF_USERS],
               y_ids[int(rng.integers(len(y_ids)))],
               f"{rng.uniform(0.5, 3.0):.3f}")
              for j in range(PREF_EVENTS)]
    return rng, pref_users, events


def lambda_loop(work_dir: str, lam: float) -> dict:
    """Phase 5b: one batch generation, the serving and speed layers
    loading it, /pref events through the serving layer's HTTP, one speed
    micro-batch, and the serving layer answering with its UP vectors;
    the ``lambda`` line."""
    import torch
    from oryx_tpu_torch.app.als import slices
    from oryx_tpu_torch.common import pmml as pmml_io
    from oryx_tpu_torch.kafka.inproc import resolve_broker
    from oryx_tpu_torch.lambda_rt.batch import BatchLayer
    from oryx_tpu_torch.lambda_rt.serving import ServingLayer
    from oryx_tpu_torch.lambda_rt.speed import SpeedLayer

    cfg = loop_config(work_dir)
    broker = resolve_broker(cfg.get_string("oryx.input-topic.broker"))
    in_topic = cfg.get_string("oryx.input-topic.message.topic")
    up_topic = cfg.get_string("oryx.update-topic.message.topic")
    with open(os.path.join(work_dir, "lambda_data.json"),
              encoding="utf-8") as f:
        prepared = json.load(f)
    check(sum(broker.latest_offsets(in_topic)) == prepared["loop_lines"],
          "lambda: the input topic does not hold the prepared lines")
    free()

    # the batch generation
    batch = BatchLayer(cfg, device=DEVICE)
    t0 = time.perf_counter()
    batch.run_one_generation()
    generation_s = time.perf_counter() - t0
    # its side door: the freshness gauges after the generation
    batch.obs_server.start()
    try:
        status, body, _ = http_call(batch.obs_server.port, "GET",
                                    "/metrics")
    finally:
        batch.close()
    batch_fresh = json.loads(body)["freshness"] if status == 200 else {}
    check(batch_fresh.get("batch_generation_records")
          == prepared["loop_lines"]
          and batch_fresh.get("input_lag_records") == 0
          and batch_fresh.get("batch_generation_age_sec") is not None,
          f"lambda: the batch side door's /metrics gave {status}: "
          f"{batch_fresh}")
    stages = dict(batch.update_instance.stage_s)
    check(broker.get_offsets(batch._group, in_topic)
          == broker.latest_offsets(in_topic),
          "lambda: the generation did not commit its offsets")
    ups_end = broker.latest_offsets(up_topic)
    published = broker.read_ranges(up_topic, [0] * len(ups_end), ups_end)
    check([m.key for m in published] == ["MODEL-REF"],
          f"lambda: the generation published {[m.key for m in published]}")
    pmml_path, _, manifest = slices.parse_model_ref(published[0].message)
    check(manifest is not None and manifest["ring"] == LOOP_SLICES
          and len(manifest["slices"]) == LOOP_SLICES,
          "lambda: the MODEL-REF manifest does not name 8 slices")
    doc = pmml_io.read(pmml_path)
    check(pmml_io.get_extension_value(doc, "features") == str(TRAIN_RANK)
          and float(pmml_io.get_extension_value(doc, "lambda")) == lam
          and pmml_io.get_extension_value(doc, "implicit") == "true",
          "lambda: the PMML lacks the features, lambda or implicit flag")
    x_ids = pmml_io.get_extension_content(doc, "XIDs")
    y_ids = pmml_io.get_extension_content(doc, "YIDs")

    # the serving and speed layers load it off the update topic
    serving = ServingLayer(cfg, port=0, device=DEVICE)
    speed = SpeedLayer(cfg, device=DEVICE)
    t0 = time.perf_counter()
    serving.start()
    speed.start()
    try:
        smgr, pmgr = serving.model_manager, speed.model_manager

        # loaded: every slice read (the counters move once a manifest's
        # load, known items included, is done) and every id held
        def ready() -> bool:
            status, _, _ = http_call(serving.port, "GET", "/ready")
            model = smgr.get_model()
            return status == 204 and smgr.slice_loads == LOOP_SLICES \
                and model.user_count() == len(x_ids) \
                and model.item_count() == len(y_ids)

        wait_for(ready, "lambda: the serving layer's load", LOOP_WAIT_S)
        serving_load_s = time.perf_counter() - t0
        wait_for(lambda: pmgr.slice_loads == LOOP_SLICES
                 and pmgr.model.user_count() == len(x_ids)
                 and pmgr.model.item_count() == len(y_ids),
                 "lambda: the speed layer's load", LOOP_WAIT_S)
        speed_load_s = time.perf_counter() - t0
        check(smgr.slice_loads == pmgr.slice_loads == LOOP_SLICES
              and smgr.slice_load_fallbacks == 0
              and pmgr.slice_load_fallbacks == 0,
              f"lambda: slice loads {smgr.slice_loads}/{pmgr.slice_loads}")
        model, smodel = smgr.get_model(), pmgr.model

        # /pref events through the serving layer, from now on
        broker.set_offsets(speed._group, in_topic,
                           broker.latest_offsets(in_topic))
        in_before = broker.latest_offsets(in_topic)
        rng, pref_users, events = pref_events(x_ids, y_ids)
        t0 = time.perf_counter()
        # the first /pref arrives sampled: its trace follows the record
        # to the speed layer's fold-in
        trace_id = f"{int(rng.integers(1, 2**62)):032x}"
        t_last_pref = post_prefs(serving.port, events, {
            "traceparent": f"00-{trace_id}-{'1' * 16}-01"})
        pref_s = t_last_pref - t0
        new_data = broker.read_ranges(in_topic, in_before,
                                      broker.latest_offsets(in_topic))
        check(len(new_data) == PREF_EVENTS,
              f"lambda: {len(new_data)} of {PREF_EVENTS} /pref records")
        # the speed model's vectors before the micro-batch
        snap = {"X": {}, "Y": {}}
        for side, store in (("X", smodel.X), ("Y", smodel.Y)):
            host, active, row_ids = store.host_arrays()
            rows = host[active].astype(np.float64)
            snap[f"{side}t{side}"] = rows.T @ rows
            snap[side] = {row_ids[r]: host[r].astype(np.float64)
                          for r in np.nonzero(active)[0]}
        up_before = broker.latest_offsets(up_topic)
        t0 = time.perf_counter()
        speed.run_one_micro_batch()
        micro_batch_s = time.perf_counter() - t0
        check(speed.last_micro_batch["records"] == PREF_EVENTS,
              f"lambda: the micro-batch read {speed.last_micro_batch}")
        # the speed layer's side door: its freshness gauges, and the
        # sampled /pref's fold-in span under the serving layer's
        # request span
        door = speed.obs_server.port
        status, body, _ = http_call(door, "GET", "/metrics")
        speed_fresh = json.loads(body)["freshness"] if status == 200 \
            else {}
        check(speed_fresh.get("micro_batch_records") == PREF_EVENTS
              and speed_fresh.get("ingest_to_servable_ms") is not None
              and speed_fresh.get("input_lag_records") == 0
              and "update_lag_records" in speed_fresh,
              f"lambda: the speed side door's /metrics gave {status}: "
              f"{speed_fresh}")
        request_spans = json.loads(http_call(
            serving.port, "GET", "/admin/traces")[1])["traces"].get(
                trace_id, [])
        fold_spans = json.loads(http_call(
            door, "GET", "/admin/traces")[1])["traces"].get(trace_id, [])
        check([s["name"] for s in request_spans] == ["serving.request"]
              and [s["name"] for s in fold_spans] == ["speed.fold_in"]
              and fold_spans[0]["parent_id"] == request_spans[0]["span_id"],
              f"lambda: trace {trace_id}: serving {request_spans}, speed "
              f"{fold_spans}")
        ups = [json.loads(m.message) for m in broker.read_ranges(
            up_topic, up_before, broker.latest_offsets(up_topic))]
        want = expected_ups(new_data, snap, smodel.implicit)
        got = {(u[0], u[1], u[3][0]): np.asarray(u[2], np.float32)
               for u in ups}
        check(len(got) == len(ups) and set(got) == set(want),
              f"lambda: {len(ups)} UP records for {len(want)} expected "
              f"updates ({len(set(got) ^ set(want))} differ)")
        err = max(float(np.max(np.abs(got[k] - v) / (FOLD_ATOL + FOLD_RTOL
                                                    * np.abs(v))))
                  for k, v in want.items())
        check(err <= 1.0, f"lambda: an UP vector is {err} times the fold-in "
              f"tolerance from the float64 loop")
        max_abs = max(float(np.max(np.abs(got[k] - v)))
                      for k, v in want.items())
        # each user's last X record is what serving ends up holding
        last_x = {}
        for u in ups:
            if u[0] == "X":
                last_x[u[1]] = np.asarray(u[2], np.float32)
        check(set(last_x) == set(pref_users),
              f"lambda: {len(last_x)} of {PREF_USERS} users got an X update")
        wait_for(lambda: all(np.array_equal(model.get_user_vector(u), v)
                             for u, v in last_x.items()),
                 "lambda: serving to apply the UP records", LOOP_WAIT_S)
        applied_ms = (time.perf_counter() - t_last_pref) * 1e3
        status, body, _ = http_call(serving.port, "GET",
                                    f"/recommend/{events[-1][0]}?howMany=10")
        answer_ms = (time.perf_counter() - t_last_pref) * 1e3
        check(status == 200, f"lambda: /recommend answered {status}")
        # every pref user's answer: the NumPy top-k of its UP vector, its
        # known items excluded
        host, active, row_ids = model.Y.host_arrays()
        row_of = {iid: r for r, iid in enumerate(row_ids) if iid is not None}
        same = 0
        for user in pref_users:
            status, body, _ = http_call(serving.port, "GET",
                                        f"/recommend/{user}?howMany=10")
            check(status == 200, f"lambda: /recommend/{user}: {status}")
            answer = [(r["id"], r["value"]) for r in json.loads(body)]
            eligible = active.copy()
            # known items come from every event of the generation, the
            # factors from its training split: an item seen only in
            # the held-out events is known and has no row (as in the
            # reference's ALSUpdate)
            for iid in model.get_known_items(user):
                if iid in row_of:
                    eligible[row_of[iid]] = False
            scores = host.astype(np.float64) @ last_x[user].astype(
                np.float64)
            held_top_n(answer, scores, eligible, row_of.get, 10,
                       f"lambda: /recommend/{user}", RTOL["float32"])
            top = np.argsort(-np.where(eligible, scores, -np.inf),
                             kind="stable")[:10]
            same += [row_ids[r] for r in top] == [i for i, _ in answer]
    finally:
        speed.close()
        serving.close()
    check(not serving.consuming and not speed.consuming,
          "lambda: a consumer outlived close()")
    line = {"phase": "lambda", "input_lines": prepared["loop_lines"],
            "users": len(x_ids), "items": len(y_ids),
            "generation_s": generation_s,
            **{f"{k}_s": v for k, v in sorted(stages.items())},
            "other_s": generation_s - sum(stages.values()),
            "slices": len(manifest["slices"]),
            "serving_load_s": serving_load_s,
            "serving_model_load_s": smgr.model_load_s,
            "speed_load_s": speed_load_s,
            "speed_model_load_s": pmgr.model_load_s,
            "pref_events": PREF_EVENTS, "pref_users": PREF_USERS,
            "pref_post_s": pref_s, "micro_batch_s": micro_batch_s,
            "up_records": len(ups), "up_max_abs_err": max_abs,
            "up_err_of_tolerance": err,
            "pref_to_applied_ms": applied_ms,
            "pref_to_answer_ms": answer_ms,
            "recommend_checked": len(pref_users),
            "recommend_same_ids": same,
            "batch_freshness": batch_fresh, "speed_freshness": speed_fresh,
            "fold_in_span_ms": fold_spans[0]["duration_ms"],
            "synth_s": prepared["synth_s"],
            "input_write_s": prepared["loop_write_s"]}
    log(line)
    return line


# -- phase 6: the IVF index and the k-means app ------------------------------

@contextlib.contextmanager
def timed_calls(targets: dict):
    """Wrap each ``(module, name)`` of ``targets`` so that its calls add
    their seconds (the card synchronised at both ends) to the yielded
    dict under the target's label, and count under ``<label>_calls``."""
    import torch
    seconds = {label: 0.0 for label in targets}
    seconds.update({f"{label}_calls": 0 for label in targets})
    saved = {}
    for label, (mod, name) in targets.items():
        real = getattr(mod, name)
        saved[label] = (mod, name, real)

        def timed(*args, _real=real, _label=label, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                seconds[_label] += time.perf_counter() - t0
                seconds[f"{_label}_calls"] += 1
        setattr(mod, name, timed)
    try:
        yield seconds
    finally:
        for mod, name, real in saved.values():
            setattr(mod, name, real)


def ann_catalog(n: int, features: int, cells: int, seed: int) -> np.ndarray:
    """Item factors from a gaussian mixture of ``cells // 4`` components,
    each item its component plus 0.25 standard normal noise, rounded to 4
    decimals: bench/gateway.py:181-185's draw for its ANN rung (:1517),
    in float32 throughout."""
    rng = np.random.default_rng(seed)
    comp = rng.standard_normal((max(2, cells // 4), features),
                               dtype=np.float32)
    y = rng.standard_normal((n, features), dtype=np.float32)
    y *= np.float32(0.25)
    pick = rng.integers(0, len(comp), size=n)
    for s in range(0, n, 1 << 20):
        y[s:s + (1 << 20)] += comp[pick[s:s + (1 << 20)]]
    np.round(y, 4, out=y)
    return y


def ann_settings(**overrides):
    """The serving config with the IVF index on, reference.conf's ANN
    defaults (788-826) unless overridden."""
    from oryx_tpu_torch.common.config import get_default, overlay_on
    return overlay_on({"oryx.als.ann.enabled": True, **overrides},
                      get_default())


def row_cells(mirror, bs: int, n_rows: int) -> np.ndarray:
    """The cell of every one of the store's ``n_rows`` rows (-1 for a
    retired row), from the mirror's layout."""
    perm = mirror.perm.cpu().numpy()
    valid = mirror.activep.cpu().numpy()
    cb = mirror.cell_blocks.cpu().numpy()
    n_blocks = len(perm) // bs
    block_cell = np.full(n_blocks, -1, np.int64)
    for c, blocks in enumerate(cb):
        block_cell[blocks[blocks != n_blocks - 1]] = c
    slot_cell = np.repeat(block_cell, bs)
    out = np.full(n_rows, -1, np.int64)
    out[perm[valid]] = slot_cell[valid]
    return out


def probed_cells(torch, Q, mirror, nprobe: int):
    """The cells a window probes: the ``nprobe`` of highest inner product
    with each query, as ``ivf.ivf_probe`` picks them."""
    from oryx_tpu_torch.app.als import serving_model as sm
    Qf = sm._q_cast(Q, mirror.cents).to(torch.float32)
    return sm._top_k(Qf @ mirror.cents.T, nprobe)[1]


def restricted_top_k(torch, vecs, active, cell_of, probe, Q, k: int):
    """Exact top-k of each query over the live rows of its probed cells
    only (plain products, in query chunks): what a certified IVF row must
    answer."""
    from oryx_tpu_torch.app.als import serving_model as sm
    ncells = int(cell_of.max()) + 1
    out_s, out_i = [], []
    for s in range(0, Q.shape[0], 8):
        q = sm._q_cast(Q[s:s + 8], vecs)
        scores = sm._scores(q, vecs)
        allowed = torch.zeros((q.shape[0], ncells), dtype=torch.bool,
                              device=vecs.device)
        allowed.scatter_(1, probe[s:s + 8], True)
        mask = allowed[:, cell_of.clamp_min(0)] & (cell_of >= 0)[None, :]
        ts, ti = sm._top_k(torch.where(mask & active[None, :], scores,
                                       float("-inf")), k)
        out_s.append(ts)
        out_i.append(ti)
    return torch.cat(out_s).cpu().numpy(), torch.cat(out_i).cpu().numpy()


def ann_windows(model, rng, label: str, route: dict) -> list[dict]:
    """Phase 6a's windows: at each ladder size, one window through the
    "ivf" kind, its probe and its phase B apart, the "i8" kind and the
    routed kind (CUDA events); the IVF rows that certify must be the
    exact top-k over their probed cells, and the "i8" kind's answer
    wherever that lies inside the probed cells."""
    import torch
    from oryx_tpu_torch.app.als import ivf
    from oryx_tpu_torch.app.als import serving_model as sm
    vecs, active, version = model.Y.device_arrays_versioned()
    n_rows, width = int(vecs.shape[0]), int(vecs.shape[1])
    bs = sm._BLOCK_ROWS
    ksel = min(sm._BLOCK_KSEL, n_rows // bs)
    k = sm._pad_k(10)
    _, fold = model._phase_a_kinds(n_rows, width, bs)
    nprobe = model._ann.cfg.nprobe
    mirror = model._cached_ivf(vecs, active, version)
    bpc = int(mirror.cell_blocks.shape[1])
    ksel_ivf = min(max(sm._i8_ksel(ksel, n_rows, bs), -(-k // bs)),
                   nprobe * bpc)
    cell_of = torch.from_numpy(row_cells(mirror, bs, n_rows)).to(DEVICE)
    chosen = route["chosen"]
    ctx: dict = {}
    out = []
    for b in WINDOWS:
        Q = torch.from_numpy(rng.standard_normal(
            (b, model.features), dtype=np.float32)).to(DEVICE)

        def run(kind):
            return lambda: model._dispatch_kind(
                kind, Q, vecs, active, version, None, None, k, bs, ksel, 0,
                fold, ctx)

        reset_launches()
        row = {"phase": "window", "config": label, "kind": "ivf", "B": b,
               "ivf_ms": time_ms(torch, run("ivf"))}
        Qc, bi, bound = ivf.ivf_probe(vecs, Q, mirror, bs, nprobe)
        row["probe_ms"] = time_ms(
            torch, lambda: ivf.ivf_probe(vecs, Q, mirror, bs, nprobe))
        row["phase_b_ms"] = time_ms(
            torch, lambda: ivf.ivf_phase_b(vecs, Qc, mirror, bi, bound, k,
                                           bs, ksel_ivf))
        row["i8_ms"] = time_ms(torch, run("i8"))
        row["routed_kind"] = chosen
        row["routed_ms"] = row["ivf_ms"] if chosen == "ivf" else \
            row["i8_ms"] if chosen == "i8" else time_ms(torch, run(chosen))
        row["launches"] = read_launches()
        # the served window end to end on the routed kind, with the exact
        # rescan of every row whose certificate fails
        q = Q.cpu().numpy()
        fb0 = model.twophase_fallbacks
        model.top_n_batch(10, q)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.top_n_batch(10, q)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        row["top_n_batch_ms"] = statistics.median(walls)
        row["fallback_rows"] = (model.twophase_fallbacks - fb0) // 4
        ts, ti, cert = (t.cpu().numpy() for t in run("ivf")())
        i8s, i8i, i8c = (t.cpu().numpy() for t in run("i8")())
        rs, ri = restricted_top_k(torch, vecs, active, cell_of,
                                  probed_cells(torch, Q, mirror, nprobe), Q,
                                  k)
        es, ei = sm._fetch(*sm._batch_top_n_chunked_kernel(
            vecs, Q, active, None, None, k, sm._stream_plan(n_rows, b)[1],
            0))
        for r in np.nonzero(cert)[0]:
            check(list(ti[r]) == list(ri[r]),
                  f"{label}: certified IVF row {r} of B={b} is not the "
                  f"exact top-{k} of its probed cells")
            np.testing.assert_allclose(ts[r], rs[r], rtol=RTOL["float32"],
                                       err_msg=f"{label}: IVF row {r}")
        # the i8 kind's served answer: its own where its row certifies,
        # the exact rescan where not.  A certified IVF row must equal it
        # wherever the exact top-k lies inside the probed cells; outside
        # them the difference is the pruning the recall certificate
        # measures, and the row is counted
        i8_ids = np.where(i8c[:, None], i8i, ei)
        i8_scores = np.where(i8c[:, None], i8s, es)
        inside = np.all(ri == ei, axis=1)
        for r in np.nonzero(cert & inside)[0]:
            check(list(ti[r]) == list(i8_ids[r]),
                  f"{label}: certified IVF row {r} of B={b} differs from "
                  f"the i8 kind's answer")
            np.testing.assert_allclose(ts[r], i8_scores[r],
                                       rtol=RTOL["float32"],
                                       err_msg=f"{label}: IVF against i8")
        row.update({"k": k, "ksel": ksel_ivf, "certified": int(cert.sum()),
                    "i8_certified": int(i8c.sum()),
                    "certified_same_as_i8": int(
                        np.all(ti[cert] == i8_ids[cert], axis=1).sum()),
                    "certified_pruned": int((cert & ~inside).sum()),
                    # rows whose whole top-k lies in the probed cells
                    "same_as_exact": int(np.all(ti == ei, axis=1).sum())})
        log(row)
        out.append(row)
    return out


def ann_exact(Y: np.ndarray, X: np.ndarray, rng) -> dict:
    """Phase 6a's ``nprobe == cells`` check on a smaller catalog: every
    row the IVF window certifies is the exact kernel's answer."""
    import torch
    from oryx_tpu_torch.app.als import ivf
    from oryx_tpu_torch.app.als import serving_model as sm
    cfg = ivf.AnnConfig.from_config(ann_settings(**{
        "oryx.als.ann.cells": ANN_EXACT_CELLS,
        "oryx.als.ann.nprobe": ANN_EXACT_CELLS}))
    model = build_model(ANN_FEATURES, Y, X, {}, "float32")
    state = ivf.AnnState(cfg, ivf.train_generation_centroids(
        Y, cfg, device=DEVICE))
    model.attach_ann(state)
    vecs, active, version = model.Y.device_arrays_versioned()
    n_rows = int(vecs.shape[0])
    mirror = model._cached_ivf(vecs, active, version)
    bs = sm._BLOCK_ROWS
    k = sm._pad_k(10)
    ksel = sm._i8_ksel(min(sm._BLOCK_KSEL, n_rows // bs), n_rows, bs)
    _, chunk = sm._stream_plan(n_rows, 256)
    certified = 0
    for b in (8, 256):
        Q = torch.from_numpy(rng.standard_normal(
            (b, ANN_FEATURES), dtype=np.float32)).to(DEVICE)
        ts, ti, cert = sm._fetch(*ivf.batch_top_n_ivf(
            mirror, vecs, Q, k, bs, ksel, ANN_EXACT_CELLS))
        es, ei = sm._fetch(*sm._batch_top_n_chunked_kernel(
            vecs, Q, active, None, None, k, chunk, 0))
        for r in np.nonzero(cert)[0]:
            check(list(ti[r]) == list(ei[r]), f"ann_exact: certified row "
                  f"{r} of B={b} is not the exact answer")
            np.testing.assert_allclose(ts[r], es[r], rtol=RTOL["float32"],
                                       err_msg=f"ann_exact: row {r}")
        certified += int(cert.sum())
    check(certified > 0, "ann_exact: no row certified")
    line = {"phase": "ann_exact", "items": len(Y), "rows": n_rows,
            "cells": ANN_EXACT_CELLS, "nprobe": ANN_EXACT_CELLS,
            "queries": 264, "certified": certified,
            "bpc": int(mirror.cell_blocks.shape[1])}
    log(line)
    return line


def ann_draw():
    """Phase 6a's catalog (``ann_catalog`` at the protocol's shape), on a
    thread of its own while phase 5 runs: its future."""
    from oryx_tpu_torch.app.als.ivf import AnnConfig
    return background(ann_catalog, ANN_ITEMS, ANN_FEATURES,
                      AnnConfig.from_config(ann_settings()).cells, ANN_SEED)


def ann_at_scale(rng, catalog=None) -> dict:
    """Phase 6a: the IVF index at the reference's protocol catalog, full
    width, built through the serving manager's path; the ``ann`` line,
    the ``window`` lines and the ``ann_exact`` line.  ``catalog`` is the
    future of ``ann_draw`` (drawn here without it)."""
    import torch
    from oryx_tpu_torch.app.als import ivf
    from oryx_tpu_torch.app.als import serving_model as sm
    from oryx_tpu_torch.app.als.serving_manager import \
        ALSServingModelManager
    from oryx_tpu_torch.ops import ann as ops_ann

    label = "10M_50f_ivf"
    mgr = ALSServingModelManager(ann_settings(), device=DEVICE)
    cfg = mgr.ann_config
    t0 = time.perf_counter()
    Y = catalog.result() if catalog is not None else \
        ann_catalog(ANN_ITEMS, ANN_FEATURES, cfg.cells, ANN_SEED)
    X = rng.standard_normal((N_USERS, ANN_FEATURES), dtype=np.float32)
    synth_s = time.perf_counter() - t0
    model = build_model(ANN_FEATURES, Y, X, {}, "float32")
    mgr.model = model
    with timed_calls({"train_s": (ivf, "train_generation_centroids"),
                      "assign_s": (ops_ann, "assign_cells"),
                      "mirror_s": (ivf, "build_mirror"),
                      "recall_s": (ivf, "measure_recall")}) as stage_s:
        t0 = time.perf_counter()
        mgr._maybe_build_ann(None)
        build_s = time.perf_counter() - t0
    # the mirror build's own seconds, its cell assignment apart
    stage_s["mirror_s"] -= stage_s["assign_s"]
    a = model._ann
    check(mgr.ann_index_fallbacks == 0, f"{label}: the index build failed "
          f"closed ({mgr.ann_index_fallbacks} fallbacks)")
    check(a is not None and a.recall is not None
          and a.recall >= cfg.min_recall,
          f"{label}: recall certificate {a and a.recall} below "
          f"{cfg.min_recall}")
    vecs, active, version = model.Y.device_arrays_versioned()
    n_rows = int(vecs.shape[0])
    bs = sm._BLOCK_ROWS
    mirror = model._cached_ivf(vecs, active, version)
    cb = mirror.cell_blocks.cpu().numpy()
    per_cell = (cb != int(mirror.y8p.shape[0]) // bs - 1).sum(axis=1)
    reset_launches()
    t0 = time.perf_counter()
    route = model.refresh_route(force=True)
    torch.cuda.synchronize()
    route_s = time.perf_counter() - t0
    check(route is not None and not route.get("errors"),
          f"{label}: route errors {route and route.get('errors')}")
    costs = route["costs_exact_ms"]
    for kind in ("ivf", "i8", "pallas"):
        check(costs.get(kind) is not None, f"{label}: {kind} not timed")
    check(route["ann"]["routable"] and route["ann"]["recall"] == a.recall,
          f"{label}: route's ann block {route['ann']}")
    line = {"phase": "ann", "config": label, "items": len(Y),
            "rows": n_rows, "features": ANN_FEATURES, "cells": cfg.cells,
            "nprobe": cfg.nprobe, "recall_at": cfg.recall_at,
            "recall_queries": cfg.recall_queries, "recall": a.recall,
            "min_recall": cfg.min_recall,
            "index_bytes": mgr.ann_index_bytes,
            "fallbacks": mgr.ann_index_fallbacks,
            "synth_s": synth_s, "build_s": build_s,
            **stage_s, "route_s": route_s,
            "bpc": int(cb.shape[1]), "largest_cell_blocks": int(per_cell.max()),
            "mean_cell_blocks": float(per_cell.mean()),
            "empty_cells": int((per_cell == 0).sum()),
            "costs_exact_ms": costs, "chosen": route["chosen"],
            "route_launches": read_launches()}
    log(line)
    ann_windows(model, rng, label, route)
    del model, mgr, mirror, vecs, active
    free()
    ann_exact(Y[:ANN_EXACT_ITEMS], X, rng)
    return line


def publish_ann_generation(model_dir: str, seed: int) -> None:
    """Phase 6b's generation, written by a child process while the card
    works on the earlier phases: the factor artifacts and PMML of a
    mixture catalog, then ALSUpdate's MODEL-REF publish with
    ``oryx.als.ann.publish-index``, which trains the coarse quantizer on
    the card and writes centroids and per-slice cells with the slices."""
    from oryx_tpu_torch.app.als.update import ALSUpdate, save_features
    from oryx_tpu_torch.common import pmml as pmml_io
    from oryx_tpu_torch.common.config import get_default, overlay_on
    t0 = time.perf_counter()
    cells = get_default().get_int("oryx.als.ann.cells")
    Y = ann_catalog(ANN_TOPIC_ITEMS, ANN_FEATURES, cells, seed)
    X = np.round(np.random.default_rng(seed + 1).standard_normal(
        (ANN_TOPIC_USERS, ANN_FEATURES), dtype=np.float32), 4)
    y_ids = [f"i{j}" for j in range(len(Y))]
    x_ids = [f"u{u}" for u in range(len(X))]
    save_features(os.path.join(model_dir, "Y"), y_ids, Y)
    save_features(os.path.join(model_dir, "X"), x_ids, X)
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", ANN_FEATURES)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension(doc, "X", "X/")
    pmml_io.add_extension(doc, "Y", "Y/")
    pmml_io.add_extension_content(doc, "XIDs", x_ids)
    pmml_io.add_extension_content(doc, "YIDs", y_ids)
    pmml_path = os.path.join(model_dir, "model.pmml.xml")
    pmml_io.write(doc, pmml_path)
    artifacts_s = time.perf_counter() - t0
    update = ALSUpdate(overlay_on({
        "oryx.als.ann.publish-index": True,
        "oryx.als.publish.slices": ANN_TOPIC_RING,
        "oryx.als.no-known-items": True}, get_default()), device=DEVICE)
    message = update.prepare_model_ref_payload(doc, pmml_path, [], [])
    with open(os.path.join(model_dir, "published.json"), "w",
              encoding="utf-8") as f:
        json.dump({"message": message, "artifacts_s": artifacts_s,
                   "publish_s": update.stage_s.get("publish"),
                   "seconds": time.perf_counter() - t0}, f)


def ann_topic(publisher, work_dir: str) -> dict:
    """Phase 6b: a ServingLayer with the IVF index on loads phase 6b's
    generation off a file:// update topic, builds its index from the
    published artifacts (no local k-means) and answers /recommend over
    HTTP, each answer held against NumPy; the ``ann_topic`` line."""
    import torch
    from oryx_tpu_torch.app.als import ivf, slices
    from oryx_tpu_torch.app.als import serving_model as sm
    from oryx_tpu_torch.common.config import from_file, overlay_on
    from oryx_tpu_torch.kafka.inproc import InProcTopicProducer
    from oryx_tpu_torch.lambda_rt.serving import ServingLayer

    label = "131k_50f_ivf_topic"
    model_dir = os.path.join(work_dir, "ann_model")
    t_wait = time.perf_counter()
    publisher.join(TOPIC_WAIT_S)
    check(publisher.exitcode == 0,
          f"{label}: publishing the generation failed ({publisher.exitcode})")
    waited_s = time.perf_counter() - t_wait
    with open(os.path.join(model_dir, "published.json"),
              encoding="utf-8") as f:
        published = json.load(f)
    _, _, manifest = slices.parse_model_ref(published["message"])
    check(manifest is not None and "ann" in manifest
          and all("ann" in e for e in manifest["slices"]),
          f"{label}: the manifest names no index artifacts")
    broker = "file://" + os.path.join(work_dir, "ann_broker")
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "oryx_tpu_torch", "conf", "als-example.conf")
    cfg = overlay_on({"oryx.update-topic.broker": broker,
                      "oryx.input-topic.broker": None,
                      "oryx.als.sample-rate": 1.0,
                      "oryx.als.ann.enabled": True}, from_file(conf))
    free()
    flat_limit = sm._FLAT_SCORES_LIMIT
    sm._FLAT_SCORES_LIMIT = ANN_TOPIC_FLAT_LIMIT
    with timed_calls({"local_train_s": (ivf, "train_generation_centroids"),
                      "mirror_s": (ivf, "build_mirror"),
                      "recall_s": (ivf, "measure_recall")}) as stage_s:
        layer = ServingLayer(cfg, port=0, device=DEVICE)
        try:
            layer.start()
            mgr = layer.model_manager
            producer = InProcTopicProducer(
                broker, cfg.get_string("oryx.update-topic.message.topic"))
            reset_launches()
            t0 = time.perf_counter()
            producer.send("MODEL-REF", published["message"])

            def ready() -> bool:
                status, _, _ = http_call(layer.port, "GET", "/ready")
                model = mgr.get_model()
                return status == 204 and mgr.slice_loads == ANN_TOPIC_RING \
                    and model.user_count() == ANN_TOPIC_USERS \
                    and model._route is not None
            wait_for(ready, f"{label}: /ready", TOPIC_WAIT_S)
            ready_s = time.perf_counter() - t0
            load_stage_s = dict(stage_s)
            model = mgr.get_model()
            route = model.metrics()["kernel_route"]
            ann = route.get("ann") or {}
            check(load_stage_s["local_train_s_calls"] == 0,
                  f"{label}: the layer trained its own centroids instead of "
                  f"reading the published ones")
            check(mgr.ann_index_fallbacks == 0 and mgr.slice_load_fallbacks
                  == 0, f"{label}: fallbacks {mgr.ann_index_fallbacks} "
                  f"index, {mgr.slice_load_fallbacks} slice")
            check(ann.get("recall") is not None
                  and ann["recall"] >= ann["min_recall"]
                  and ann["routable"] and ann["index_bytes"] > 0,
                  f"{label}: kernel_route.ann {ann}")
            check(route["costs_exact_ms"].get("ivf") is not None
                  and not route.get("errors"),
                  f"{label}: route {route.get('costs_exact_ms')} errors "
                  f"{route.get('errors')}")
            # the answers: the exact top-10 over the probed cells' rows
            # where the served kind is "ivf" and the row certifies, else
            # over every row
            host, active, row_ids = model.Y.host_arrays()
            row_of = {iid: r for r, iid in enumerate(row_ids)
                      if iid is not None}
            users = [f"u{u}" for u in range(ANN_TOPIC_USERS)]
            Xu = np.stack([model.get_user_vector(u) for u in users])
            vecs, dactive, version = model.Y.device_arrays_versioned()
            serving_kind = model._route_order(
                [kk for kk in model._phase_a_kinds(
                    len(row_ids), int(vecs.shape[1]), sm._BLOCK_ROWS)[0]],
                len(row_ids))[0]
            mirror = model._cached_ivf(vecs, dactive, version)
            Qd = torch.from_numpy(Xu).to(DEVICE)
            k = sm._pad_k(10)
            _, _, cert = sm._fetch(*model._dispatch_kind(
                "ivf", Qd, vecs, dactive, version, None, None, k,
                sm._BLOCK_ROWS, min(sm._BLOCK_KSEL,
                                    len(row_ids) // sm._BLOCK_ROWS),
                0, 1, {}))
            probe = probed_cells(torch, Qd, mirror,
                                 model._ann.cfg.nprobe).cpu().numpy()
            cell_of = row_cells(mirror, sm._BLOCK_ROWS, len(row_ids))
            host64 = host.astype(np.float64)
            times, restricted = [], 0
            for j, user in enumerate(users):
                status, body, ms = http_call(layer.port, "GET",
                                             f"/recommend/{user}?howMany=10")
                check(status == 200, f"{label}: /recommend/{user}: {status}")
                times.append(ms)
                answer = [(r["id"], r["value"]) for r in json.loads(body)]
                eligible = active.copy()
                if serving_kind == "ivf" and cert[j]:
                    eligible &= np.isin(cell_of, probe[j])
                    restricted += 1
                held_top_n(answer, host64 @ Xu[j].astype(np.float64),
                           eligible, row_of.get, 10,
                           f"{label}: /recommend/{user}", RTOL["float32"])
            launches = read_launches()
        finally:
            layer.close()
            sm._FLAT_SCORES_LIMIT = flat_limit
    line = {"phase": "ann_topic", "config": label,
            "items": ANN_TOPIC_ITEMS, "features": ANN_FEATURES,
            "users": ANN_TOPIC_USERS, "ring": ANN_TOPIC_RING,
            "flat_scores_limit": ANN_TOPIC_FLAT_LIMIT,
            "publish_s": published["publish_s"],
            "artifacts_s": published["artifacts_s"],
            "child_s": published["seconds"], "waited_s": waited_s,
            "ready_s": ready_s, "model_load_s": mgr.model_load_s,
            **load_stage_s,
            "ann": ann, "costs_exact_ms": route["costs_exact_ms"],
            "chosen": route["chosen"], "serving_kind": serving_kind,
            "recommend": len(users), "held_to_probed_cells": restricted,
            "p50_ms": statistics.median(times), "p99_ms": max(times),
            "launches": launches}
    log(line)
    return line


def kmeans_points(n: int = KM_POINTS) -> np.ndarray:
    """The reference k-means bench's points (bench/apps.py:22-34): k true
    centers times 10 plus unit normal noise, seed 5 (``n`` of them)."""
    rng = np.random.default_rng(KM_SEED)
    true_centers = rng.standard_normal((KM_K, KM_DIMS)).astype(
        np.float32) * 10
    assign = rng.integers(0, KM_K, n)
    return (true_centers[assign]
            + rng.standard_normal((n, KM_DIMS), dtype=np.float32))


def nearest64(pts: np.ndarray, centers: np.ndarray, chunk: int = 500_000):
    """(index, squared distance) of each point's nearest center, float64."""
    c = centers.astype(np.float64)
    cc = np.sum(c * c, axis=1)[None, :]
    idx, d2 = [], []
    for s in range(0, len(pts), chunk):
        p = pts[s:s + chunk].astype(np.float64)
        d = np.sum(p * p, axis=1, keepdims=True) - 2.0 * p @ c.T + cc
        i = np.argmin(d, axis=1)
        idx.append(i)
        d2.append(np.maximum(d[np.arange(len(i)), i], 0.0))
    return np.concatenate(idx), np.concatenate(d2)


def card_nearest64(torch, pts64, centers64, chunk: int = 1 << 20):
    """``nearest64`` in float64 on the card, plain torch (the host's
    NumPy took ~9 s per pass over 5M points on the card's machine)."""
    cc = torch.sum(centers64 * centers64, dim=1)[None, :]
    idx, d2 = [], []
    for s in range(0, int(pts64.shape[0]), chunk):
        p = pts64[s:s + chunk]
        d = torch.sum(p * p, dim=1, keepdim=True) - 2.0 * p @ centers64.T + cc
        i = torch.argmin(d, dim=1)
        idx.append(i)
        d2.append(d.gather(1, i[:, None])[:, 0].clamp_min(0.0))
    return torch.cat(idx), torch.cat(d2)


def card_lloyd_step64(torch, pts64, centers64):
    """One Lloyd step in float64 on the card, plain torch: nearest
    centers, then each center the mean of its points (an empty cluster
    keeps its center)."""
    idx, _ = card_nearest64(torch, pts64, centers64)
    k = int(centers64.shape[0])
    counts = torch.bincount(idx, minlength=k).to(torch.float64)
    sums = torch.zeros_like(centers64).index_add_(0, idx, pts64)
    return torch.where((counts > 0)[:, None],
                       sums / counts.clamp_min(1.0)[:, None], centers64)


def metrics64(centers: np.ndarray, pts: np.ndarray) -> dict:
    """The four evaluation metrics in float64 NumPy, by the reference's
    definitions (evaluation.py): SSE, Davies-Bouldin, Dunn, silhouette
    (size-1 clusters contributing 0)."""
    c = centers.astype(np.float64)
    p = pts.astype(np.float64)
    k = len(c)
    idx, d2 = nearest64(p, c)
    dist = np.sqrt(d2)
    counts = np.bincount(idx, minlength=k).astype(np.float64)
    mean_dist = np.where(counts > 0, np.bincount(idx, weights=dist,
                                                 minlength=k)
                         / np.maximum(counts, 1), 0.0)
    center_d = np.sqrt(((c[:, None, :] - c[None, :, :]) ** 2).sum(-1))
    ratio = (mean_dist[:, None] + mean_dist[None, :]) / np.where(
        center_d > 0, center_d, np.inf)
    np.fill_diagonal(ratio, 0.0)
    inter = center_d[np.triu_indices(k, 1)]
    pp = np.sum(p * p, axis=1)
    onehot = np.eye(k)[idx]
    total = 0.0
    for s in range(0, len(p), 2000):
        q = p[s:s + 2000]
        D = np.sqrt(np.maximum(pp[s:s + 2000, None] - 2.0 * q @ p.T
                               + pp[None, :], 0.0))
        sums = D @ onehot
        rows = np.arange(len(q))
        own = idx[s:s + 2000]
        with np.errstate(divide="ignore", invalid="ignore"):
            a = sums[rows, own] / (counts[own] - 1)
            other = np.where(counts[None, :] > 0, sums / counts[None, :],
                             np.inf)
            other[rows, own] = np.inf
            b = other.min(axis=1)
            m = np.maximum(a, b)
            term = np.where(m == 0, 0.0, (b - a) / m)
        total += float(np.sum(np.where((counts[own] > 1) & np.isfinite(b),
                                       term, 0.0)))
    return {"SSE": float(d2.sum()), "DAVIES_BOULDIN": float(
                ratio.max(axis=1).mean()),
            "DUNN": float(inter.min() / mean_dist.max()),
            "SILHOUETTE": total / len(p)}


def kmeans_at_scale() -> dict:
    """Phase 6c: k-means on the card at the reference bench's shape with
    both initializations and the app's default runs, the bench's quality
    gate, every Lloyd step of the random run's first run against a
    float64 step from the same centers (plain torch on the card), and the
    four evaluation metrics against float64 NumPy on a sample; the
    ``kmeans`` line."""
    import torch
    from oryx_tpu_torch.app.kmeans import evaluation
    from oryx_tpu_torch.app.kmeans.trainer import _lloyd, train_kmeans
    t0 = time.perf_counter()
    pts = kmeans_points()
    dev = torch.from_numpy(pts).to(DEVICE)
    dev64 = dev.to(torch.float64)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    baseline_var = float(((pts - pts.mean(axis=0)) ** 2).sum(axis=1).mean())
    # the first call pays the library's start-up, not the training
    train_kmeans(dev, KM_K, 1, runs=1, initialization="random",
                 seed=KM_SEED + 1)
    line = {"phase": "kmeans", "points": KM_POINTS, "dims": KM_DIMS,
            "k": KM_K, "iterations": KM_ITERATIONS, "runs": KM_RUNS,
            "data_s": data_s, "baseline_var": baseline_var,
            "quality_gate": "mean_sq_dist < 0.1 * baseline_var"}
    clusters = {}
    for init in ("random", "k-means||"):
        free()
        torch.cuda.reset_peak_memory_stats()
        timings: dict = {}
        t0 = time.perf_counter()
        clusters[init] = train_kmeans(dev, KM_K, KM_ITERATIONS, runs=KM_RUNS,
                                      initialization=init, seed=KM_SEED,
                                      timings=timings)
        train_s = time.perf_counter() - t0
        centers = np.stack([c.center for c in clusters[init]]).astype(
            np.float32)
        _, d2 = card_nearest64(torch, dev64, torch.from_numpy(
            centers.astype(np.float64)).to(DEVICE))
        msd = float(d2.mean())
        check(msd < 0.1 * baseline_var, f"kmeans {init}: mean squared "
              f"distance {msd} fails the gate 0.1 * {baseline_var}")
        line[init] = {"train_s": train_s, "init_s": timings["init_s"],
                      "lloyd_s": timings["lloyd_s"],
                      "iteration_s": timings["lloyd_s"]
                      / (KM_RUNS * KM_ITERATIONS),
                      "mean_sq_dist": msd,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
    # each step of the random run's first run (its first draw of rows)
    # against a float64 step from the same centers: a whole float32 run
    # drifts from a float64 one by the assignments its rounding flips near
    # cluster boundaries, which later steps carry on
    t0 = time.perf_counter()
    rows = np.random.default_rng(KM_SEED).choice(KM_POINTS, KM_K,
                                                 replace=False)
    centers = dev[torch.from_numpy(rows).to(DEVICE)]
    worst = 0.0
    for _ in range(KM_ITERATIONS):
        want = card_lloyd_step64(torch, dev64, centers.to(torch.float64))
        centers = _lloyd(dev, centers, 1)[0]
        err = float(torch.max((centers.to(torch.float64) - want).abs()
                              / (KM_RTOL * want.abs()
                                 + KM_RTOL * want.abs().max())))
        worst = max(worst, err)
    check(worst <= 1.0, f"kmeans random: a Lloyd step is {worst} times the "
          f"tolerance from its float64 step")
    line["random"].update({"f64_steps": KM_ITERATIONS,
                           "f64_step_err_of_tolerance": worst,
                           "f64_check_s": time.perf_counter() - t0})
    # the four metrics on a sample, against float64
    sample = pts[np.random.default_rng(KM_SEED + 2).choice(
        KM_POINTS, KM_EVAL_SAMPLE, replace=False)]
    want = metrics64(np.stack([c.center for c in clusters["random"]]),
                     sample)
    evals = {}
    for strategy in evaluation.EVAL_STRATEGIES:
        t0 = time.perf_counter()
        got_m = evaluation.evaluate(strategy, clusters["random"], sample,
                                    device=DEVICE)
        seconds = time.perf_counter() - t0
        value = -got_m if strategy in ("SSE", "DAVIES_BOULDIN") else got_m
        rel = abs(value - want[strategy]) / abs(want[strategy])
        check(rel <= KM_RTOL, f"kmeans: {strategy} {value} is {rel} from "
              f"float64's {want[strategy]}")
        evals[strategy] = {"value": value, "f64": want[strategy],
                           "rel_err": rel, "seconds": seconds}
    line["evaluation"] = {"sample": KM_EVAL_SAMPLE, **evals}
    log(line)
    del dev, dev64
    return line


def kmeans_loop_config(work_dir: str):
    """Phase 6d's config: the port's k-means example config on a file://
    broker and directories under ``work_dir``."""
    from oryx_tpu_torch.common.config import from_file, overlay_on
    loop = os.path.join(work_dir, "kloop")
    broker = "file://" + os.path.join(loop, "broker")
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "oryx_tpu_torch", "conf", "kmeans-example.conf")
    return overlay_on({
        "oryx.input-topic.broker": broker,
        "oryx.update-topic.broker": broker,
        "oryx.batch.storage.data-dir": os.path.join(loop, "data"),
        "oryx.batch.storage.model-dir": os.path.join(loop, "model"),
        # the run drives the micro-batch itself
        "oryx.speed.streaming.generation-interval-sec": 3600,
    }, from_file(conf))


def kmeans_loop(work_dir: str) -> dict:
    """Phase 6d: the k-means lambda loop through the port's three layers
    from oryx_tpu_torch/conf/kmeans-example.conf; the ``kmeans_loop``
    line."""
    from oryx_tpu_torch.app.kmeans import pmml as kmeans_pmml
    from oryx_tpu_torch.common import pmml as pmml_io
    from oryx_tpu_torch.kafka import utils as kafka_utils
    from oryx_tpu_torch.kafka.inproc import InProcTopicProducer, \
        resolve_broker
    from oryx_tpu_torch.lambda_rt.batch import BatchLayer
    from oryx_tpu_torch.lambda_rt.serving import ServingLayer
    from oryx_tpu_torch.lambda_rt.speed import SpeedLayer

    label = "kmeans_loop"
    cfg = kmeans_loop_config(work_dir)
    k = cfg.get_int("oryx.kmeans.hyperparams.k")
    dims = cfg.get_int("oryx.input-schema.num-features")
    broker_uri = cfg.get_string("oryx.input-topic.broker")
    broker = resolve_broker(broker_uri)
    in_topic = cfg.get_string("oryx.input-topic.message.topic")
    up_topic = cfg.get_string("oryx.update-topic.message.topic")
    rng = np.random.default_rng(KLOOP_SEED)
    blob = rng.standard_normal((k, dims)) * 10
    pts = blob[rng.integers(0, k, KLOOP_POINTS)] + rng.standard_normal(
        (KLOOP_POINTS, dims))
    kafka_utils.maybe_create_topic(
        broker_uri, in_topic,
        partitions=kafka_utils.input_topic_partitions(cfg))
    InProcTopicProducer(broker_uri, in_topic).send_many(
        [(None, ",".join(f"{v:.4f}" for v in p), None) for p in pts])

    batch = BatchLayer(cfg, device=DEVICE)
    t0 = time.perf_counter()
    batch.run_one_generation()
    generation_s = time.perf_counter() - t0
    check(broker.get_offsets(batch._group, in_topic)
          == broker.latest_offsets(in_topic),
          f"{label}: the generation did not commit its offsets")
    ends = broker.latest_offsets(up_topic)
    published = broker.read_ranges(up_topic, [0] * len(ends), ends)
    check([m.key for m in published] == ["MODEL"],
          f"{label}: the generation published {[m.key for m in published]}")
    trained = kmeans_pmml.read_clusters(pmml_io.from_string(
        published[0].message))
    # trained on the generation's train split (ml.eval.test-fraction)
    check(len(trained) == k and sum(c.count for c in trained)
          <= KLOOP_POINTS, f"{label}: {len(trained)} clusters")

    serving = ServingLayer(cfg, port=0, device=DEVICE)
    speed = SpeedLayer(cfg, device=DEVICE)
    t0 = time.perf_counter()
    serving.start()
    speed.start()
    try:
        smgr, pmgr = serving.model_manager, speed.model_manager
        wait_for(lambda: http_call(serving.port, "GET", "/ready")[0] == 204,
                 f"{label}: /ready", LOOP_WAIT_S)
        serving_load_s = time.perf_counter() - t0
        wait_for(lambda: pmgr.model is not None, f"{label}: the speed load",
                 LOOP_WAIT_S)
        speed_load_s = time.perf_counter() - t0
        model = smgr.get_model()
        served = np.stack([c.center for c in model.clusters])
        ids = [c.id for c in model.clusters]
        probes = pts[rng.choice(KLOOP_POINTS, KLOOP_PROBES, replace=False)] \
            + 0.5 * rng.standard_normal((KLOOP_PROBES, dims))
        data = [",".join(f"{v:.4f}" for v in p) for p in probes]
        vals = np.array([[float(v) for v in d.split(",")] for d in data])
        # the speed layer's points, parsed to float32
        vals32 = vals.astype(np.float32).astype(np.float64)
        dist = np.sqrt(((vals[:, None, :] - served[None]) ** 2).sum(-1))
        want = [ids[j] for j in np.argmin(dist, axis=1)]
        times = []
        for d, w, dd in zip(data, want, dist.min(axis=1)):
            status, body, ms = http_call(serving.port, "GET", f"/assign/{d}")
            times.append(ms)
            check(status == 200 and json.loads(body) == str(w),
                  f"{label}: /assign/{d} answered {status} {body!r}, "
                  f"NumPy {w}")
            status, body, _ = http_call(serving.port, "GET",
                                        f"/distanceToNearest/{d}")
            check(status == 200 and abs(float(json.loads(body)) - dd)
                  <= 1e-12 * max(1.0, dd),
                  f"{label}: /distanceToNearest/{d} {body!r}, NumPy {dd}")
        status, body, post_ms = http_call(serving.port, "POST", "/assign",
                                          "\n".join(data).encode())
        check(status == 200, f"{label}: POST /assign answered {status}")
        two = np.sort(dist, axis=1)[:, :2]
        tied = two[:, 1] - two[:, 0] <= 1e-5 * two[:, 1]
        got = json.loads(body)
        check(all(g == str(w) or t for g, w, t in zip(got, want, tied)),
              f"{label}: POST /assign differs from NumPy off a near tie")

        # /add onto the input topic, then one speed micro-batch
        broker.set_offsets(speed._group, in_topic,
                           broker.latest_offsets(in_topic))
        in_before = broker.latest_offsets(in_topic)
        before = {c.id: (c.center.copy(), c.count)
                  for c in pmgr.model.clusters}
        t0 = time.perf_counter()
        for d in data[:8]:
            check(http_call(serving.port, "GET", f"/add/{d}")[0] == 204,
                  f"{label}: /add/{d}")
        check(http_call(serving.port, "POST", "/add",
                        "\n".join(data[8:]).encode())[0] == 204,
              f"{label}: POST /add")
        t_last_add = time.perf_counter()
        add_s = t_last_add - t0
        new = broker.read_ranges(in_topic, in_before,
                                 broker.latest_offsets(in_topic))
        check(sorted(m.message for m in new) == sorted(data),
              f"{label}: {len(new)} input records for {len(data)} added")
        up_before = broker.latest_offsets(up_topic)
        t0 = time.perf_counter()
        speed.run_one_micro_batch()
        micro_batch_s = time.perf_counter() - t0
        ups = [json.loads(m.message) for m in broker.read_ranges(
            up_topic, up_before, broker.latest_offsets(up_topic))]
        centers = np.stack([before[i][0] for i in sorted(before)])
        order = sorted(before)
        near = np.argmin(((vals32[:, None, :] - centers[None]) ** 2).sum(-1),
                         axis=1)
        expect = {}
        for j in np.unique(near):
            members = vals32[near == j]
            c, n = before[order[j]]
            expect[order[j]] = (c + len(members) / (n + len(members))
                                * (members.mean(axis=0) - c),
                                n + len(members))
        check(sorted(u[0] for u in ups) == sorted(expect),
              f"{label}: UP clusters {sorted(u[0] for u in ups)}, float64 "
              f"{sorted(expect)}")
        up_err = 0.0
        for cid, center, count in ups:
            check(count == expect[cid][1], f"{label}: cluster {cid} count "
                  f"{count}, float64 {expect[cid][1]}")
            up_err = max(up_err, float(np.max(np.abs(
                np.asarray(center) - expect[cid][0]))))
        check(up_err <= 1e-9, f"{label}: an UP center is {up_err} from the "
              f"float64 moving average")
        wait_for(lambda: all(
            smgr.get_model().get_cluster(cid).count == count
            for cid, _, count in ups), f"{label}: serving to apply the UPs",
            LOOP_WAIT_S)
        applied_ms = (time.perf_counter() - t_last_add) * 1e3
        for cid, center, _ in ups:
            check(np.array_equal(smgr.get_model().get_cluster(cid).center,
                                 np.asarray(center)),
                  f"{label}: serving holds another center for {cid}")
    finally:
        speed.close()
        serving.close()
    check(not serving.consuming and not speed.consuming,
          f"{label}: a consumer outlived close()")
    line = {"phase": "kmeans_loop", "points": KLOOP_POINTS, "dims": dims,
            "k": k, "generation_s": generation_s,
            "serving_load_s": serving_load_s, "speed_load_s": speed_load_s,
            "assign_checked": len(data), "assign_p50_ms":
            statistics.median(times), "assign_post_ms": post_ms,
            "near_ties": int(tied.sum()), "added": len(data),
            "add_s": add_s, "micro_batch_s": micro_batch_s,
            "up_records": len(ups), "up_max_abs_err": up_err,
            "add_to_applied_ms": applied_ms}
    log(line)
    return line


# -- phase 7: the random decision forest app ---------------------------------

@contextlib.contextmanager
def patched(mod, **fns):
    """Set the named attributes of ``mod`` for the block."""
    saved = {name: getattr(mod, name) for name in fns}
    try:
        for name, fn in fns.items():
            setattr(mod, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(mod, name, fn)


def rdf_bench_data(n: int, seed: int, regression: bool):
    """bench/apps.py:103-119's draw: uniform predictors in [-1, 1), the
    label x0 + 0.5 x1 - 0.25 x2 > 0 (or that sum plus 0.1 standard
    normal noise for regression), the first tenth held out."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, RDF_PREDICTORS)).astype(np.float32)
    s = x[:, 0] + 0.5 * x[:, 1] - 0.25 * x[:, 2]
    y = (s + 0.1 * rng.standard_normal(n)).astype(np.float32) \
        if regression else (s > 0).astype(np.int32)
    n_test = n // 10
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test], rng


def rdf_schema(regression: bool):
    from oryx_tpu_torch.app.schema import InputSchema
    from oryx_tpu_torch.common.config import from_dict
    names = [f"f{i}" for i in range(RDF_PREDICTORS)] + ["label"]
    return InputSchema(from_dict({
        "oryx.input-schema.feature-names": names,
        "oryx.input-schema.numeric-features":
            names if regression else names[:-1],
        "oryx.input-schema.target-feature": "label"}))


def rdf_level_checks(trainer, y: np.ndarray, num_classes: int,
                     hist_levels: int, stats: dict):
    """Wrappers of the trainer's level functions that check, as the build
    runs (their seconds in ``stats["check_s"]``): the first
    ``hist_levels`` levels' histograms against a float64 NumPy count of
    the same slots and weights (exact for classification, whose sums are
    integers) and slot counts against an integer recount; every level's
    advance against a NumPy walk of the same split tables."""
    import torch
    state = {"w": None, "binned": None, "binned_t": None, "levels": 0}
    real_boot, real_bin = trainer._bootstrap_weights, trainer._bin_features
    real_hist, real_counts = trainer._histograms, trainer._slot_counts
    real_advance = trainer._advance

    def boot(*args):
        w = real_boot(*args)
        state["w"] = w.cpu().numpy().astype(np.float64)
        return w

    def bin_features(*args):
        out = real_bin(*args)
        state["binned"] = out[0]
        state["binned_t"] = np.ascontiguousarray(out[0].T)
        return out

    def hist(binned, ychan, w, slot_of, num_slots, num_bins, exact_lowp):
        out = real_hist(binned, ychan, w, slot_of, num_slots, num_bins,
                        exact_lowp)
        level = state["levels"]
        if level >= hist_levels or binned.shape[1] != RDF_PREDICTORS:
            return out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = out.cpu().numpy().astype(np.float64)
        slots = slot_of.cpu().numpy()
        bins = state["binned"]
        worst = 0.0
        for t in range(slots.shape[0]):
            alive = slots[t] >= 0
            wa = state["w"][t][alive]
            if num_classes:
                # an integer recount: each example counted w times
                rows = np.repeat(np.flatnonzero(alive), wa.astype(np.int64))
                base = (slots[t][rows] * num_classes + y[rows]) * num_bins
                for p in range(RDF_PREDICTORS):
                    want = np.bincount(base + state["binned_t"][p][rows],
                                       minlength=num_slots * num_classes
                                       * num_bins)
                    check(np.array_equal(
                        got[t, :, p].transpose(0, 2, 1).ravel(), want),
                        f"rdf: level {level} tree {t} predictor {p} "
                        f"histogram differs from the integer recount")
                continue
            base = slots[t][alive] * num_bins
            ya = y[alive].astype(np.float64)
            for c, chan in enumerate((np.ones_like(ya), ya, ya * ya)):
                for p in range(RDF_PREDICTORS):
                    key = base + bins[alive, p]
                    size = num_slots * num_bins
                    want = np.bincount(key, wa * chan, size)
                    scale = np.bincount(key, np.abs(wa * chan), size)
                    err = np.abs(got[t, :, p, :, c].ravel() - want) / \
                        np.maximum(scale, 1e-30)
                    worst = max(worst, float(err.max()))
        if not num_classes:
            check(worst <= RDF_REG_RTOL, f"rdf: regression level {level} "
                  f"histogram is {worst} from float64 (of its absolute sum)")
            stats["hist_rel_err"] = max(stats.get("hist_rel_err", 0.0),
                                        worst)
        stats["hist_levels_checked"] = level + 1
        stats["check_s"] += time.perf_counter() - t0
        return out

    def slot_counts(slot_of, num_slots):
        out = real_counts(slot_of, num_slots)
        level = state["levels"]
        state["levels"] += 1
        if level >= hist_levels:
            return out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slots = slot_of.cpu().numpy()
        got = out.cpu().numpy()
        for t in range(slots.shape[0]):
            want = np.bincount(slots[t][slots[t] >= 0], minlength=num_slots)
            check(np.array_equal(got[t].astype(np.int64), want),
                  f"rdf: level {level} tree {t} slot counts differ")
        stats["check_s"] += time.perf_counter() - t0
        return out

    def advance(slot_of, binned_t, split, best_p, best_b, is_cat_slot,
                right_mask, child_slots):
        out = real_advance(slot_of, binned_t, split, best_p, best_b,
                           is_cat_slot, right_mask, child_slots)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slots, got = slot_of.cpu().numpy(), out.cpu().numpy()
        sp, bp, bb, ic, rm, ch = (a.cpu().numpy() for a in (
            split, best_p, best_b, is_cat_slot, right_mask, child_slots))
        bins = state["binned"]
        for t in range(slots.shape[0]):
            s = slots[t]
            alive = s >= 0
            sa = np.where(alive, s, 0)
            v = bins[np.arange(len(s)), bp[t][sa]]
            right = np.where(ic[t][sa], rm[t][sa, v], v > bb[t][sa])
            want = np.where(alive & sp[t][sa],
                            ch[t][sa, right.astype(np.int64)], -1)
            check(np.array_equal(got[t], want),
                  f"rdf: the advance of tree {t} differs from a NumPy walk")
        stats["advances_checked"] = stats.get("advances_checked", 0) + 1
        stats["check_s"] += time.perf_counter() - t0
        return out

    return dict(_bootstrap_weights=boot, _bin_features=bin_features,
                _histograms=hist, _slot_counts=slot_counts, _advance=advance)


def rdf_at_scale() -> dict:
    """Phase 7a: the forest trainer on the card at the reference bench's
    shape (cold build checked level by level, warm build timed by
    stage), the held-out accuracy gate, the forest walk against the host
    walk, and a regression forest; the ``rdf`` line."""
    import torch
    from oryx_tpu_torch.app.classreg import Example
    from oryx_tpu_torch.app.rdf import trainer
    from oryx_tpu_torch.app.rdf.forest_arrays import ForestArrays
    t0 = time.perf_counter()
    x, y, x_test, y_test, rng = rdf_bench_data(RDF_EXAMPLES, RDF_SEED, False)
    data_s = time.perf_counter() - t0
    schema = rdf_schema(False)
    args = (schema, {}, RDF_TREES, RDF_DEPTH, RDF_BINS, "gini")
    n_train = len(x)
    # cold: the first build of the process, its levels checked
    stats = {"check_s": 0.0}
    with patched(trainer, **rdf_level_checks(trainer, y, 2, RDF_CHECK_LEVELS,
                                             stats)):
        t0 = time.perf_counter()
        cold = trainer.train_forest(x, y, *args, seed=RDF_SEED,
                                    num_classes=2, device=DEVICE)
        cold_s = time.perf_counter() - t0
    check(stats.get("hist_levels_checked") == RDF_CHECK_LEVELS
          and stats.get("advances_checked", 0) == RDF_DEPTH,
          f"rdf: the checked build checked {stats}")
    # warm: the production steady state (the batch layer retrains every
    # generation), timed by stage
    free()
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    t0 = time.perf_counter()
    warm = trainer.train_forest(x, y, *args, seed=RDF_SEED + 1,
                                num_classes=2, timings=timings,
                                device=DEVICE)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    # held-out accuracy on a sample, scored on the card
    sample = rng.choice(len(x_test), RDF_SAMPLE, replace=False)
    full = np.full((RDF_SAMPLE, schema.num_features), np.nan, np.float32)
    full[:, :RDF_PREDICTORS] = x_test[sample]
    accuracy = {}
    for label, forest in (("cold", cold), ("warm", warm)):
        arrays = ForestArrays(forest, schema.num_features, 2, device=DEVICE)
        t0 = time.perf_counter()
        probs = arrays.predict_proba(full)
        predict_s = time.perf_counter() - t0
        accuracy[label] = float((probs.argmax(1) == y_test[sample]).mean())
        check(accuracy[label] >= RDF_MIN_ACCURACY,
              f"rdf: {label} held-out accuracy {accuracy[label]} < "
              f"{RDF_MIN_ACCURACY}")
    # the forest walk on the card against the host walk
    rows = full[:RDF_PROBA_ROWS]
    probs = probs[:RDF_PROBA_ROWS]
    host = np.stack([warm.predict(Example(
        None, [float(v) for v in row[:RDF_PREDICTORS]] + [None])
    ).category_probabilities for row in rows])
    proba_err = float(np.abs(probs - host).max())
    check(proba_err <= RDF_PROBA_TOL, f"rdf: predict_proba is {proba_err} "
          f"from the host walk")
    top2 = np.sort(host, axis=1)[:, -2:]
    near_tie = top2[:, 1] - top2[:, 0] <= 2 * RDF_PROBA_TOL
    check(np.all((probs.argmax(1) == host.argmax(1)) | near_tie),
          "rdf: the forest walk's argmax differs from the host walk's")
    # regression: the float32 histogram path
    xr, yr, xr_test, yr_test, _ = rdf_bench_data(RDF_REG_EXAMPLES,
                                                 RDF_SEED + 2, True)
    reg_stats = {"check_s": 0.0}
    with patched(trainer, **rdf_level_checks(trainer, yr, 0, 1, reg_stats)):
        t0 = time.perf_counter()
        reg = trainer.train_forest(
            xr, yr, rdf_schema(True), {}, RDF_TREES, RDF_DEPTH, RDF_BINS,
            "variance", seed=RDF_SEED + 2, device=DEVICE)
        reg_s = time.perf_counter() - t0
    full = np.full((len(xr_test), RDF_PREDICTORS + 1), np.nan, np.float32)
    full[:, :RDF_PREDICTORS] = xr_test
    pred = ForestArrays(reg, RDF_PREDICTORS + 1, 0,
                        device=DEVICE).predict_value(full)
    rmse = float(np.sqrt(np.mean((pred - yr_test) ** 2)))
    check(rmse < 0.5 * float(yr_test.std()), f"rdf: regression RMSE {rmse} "
          f"not below half the target's standard deviation {yr_test.std()}")
    line = {"phase": "rdf", "examples": n_train, "predictors": RDF_PREDICTORS,
            "trees": RDF_TREES, "max_depth": RDF_DEPTH, "bins": RDF_BINS,
            "data_s": data_s, "cold_s": cold_s,
            "cold_check_s": stats["check_s"],
            "cold_build_s": cold_s - stats["check_s"], "warm_s": warm_s,
            "warm_stages_s": timings,
            "warm_examples_x_trees_per_s": n_train * RDF_TREES / warm_s,
            "peak_bytes": peak, "accuracy": accuracy,
            "quality_gate": f"accuracy >= {RDF_MIN_ACCURACY}",
            "predict_proba_s": predict_s, "predict_rows": RDF_SAMPLE,
            "proba_max_abs_err": proba_err,
            "proba_near_ties": int(near_tie.sum()),
            "hist_levels_checked": RDF_CHECK_LEVELS,
            "advances_checked": stats["advances_checked"],
            "regression": {"examples": len(xr), "build_s": reg_s,
                           "check_s": reg_stats["check_s"], "rmse": rmse,
                           "target_std": float(yr_test.std()),
                           "hist_rel_err": reg_stats["hist_rel_err"]}}
    log(line)
    return line


def rdf_loop_config(work_dir: str):
    """Phase 7b's config: the port's RDF example config on a file://
    broker and directories under ``work_dir``."""
    from oryx_tpu_torch.common.config import from_file, overlay_on
    loop = os.path.join(work_dir, "rloop")
    broker = "file://" + os.path.join(loop, "broker")
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "oryx_tpu_torch", "conf", "rdf-example.conf")
    return overlay_on({
        "oryx.input-topic.broker": broker,
        "oryx.update-topic.broker": broker,
        "oryx.batch.storage.data-dir": os.path.join(loop, "data"),
        "oryx.batch.storage.model-dir": os.path.join(loop, "model"),
        # the run drives the micro-batch itself
        "oryx.speed.streaming.generation-interval-sec": 3600,
    }, from_file(conf))


def covtype_lines(rng, n: int, labeled: bool = True) -> list[str]:
    """Covtype-shaped lines of rdf-example.conf's schema: elevation
    (metres) and slope (degrees) numeric, ``soil`` one of 40 values,
    ``cover`` one of 7 classes set by the elevation band and the soil's
    group, 5 % of labels replaced at random; empty cover when not
    ``labeled``."""
    elevation = rng.integers(1850, 3850, n)
    slope = rng.integers(0, 61, n)
    soil = rng.integers(0, RLOOP_SOILS, n)
    band = (elevation - 1850) * 7 // 2000
    cover = (band + (soil % 4 == 0) + (slope > 45)) % 7
    noisy = rng.random(n) < RLOOP_NOISE
    cover = np.where(noisy, rng.integers(0, 7, n), cover)
    return [f"{e},{s},soil{k},{f'c{c + 1}' if labeled else ''}"
            for e, s, k, c in zip(elevation, slope, soil, cover)]


def rdf_loop(work_dir: str) -> dict:
    """Phase 7b: the RDF lambda loop through the port's three layers from
    oryx_tpu_torch/conf/rdf-example.conf; the ``rdf_loop`` line."""
    from oryx_tpu_torch.app import pmml_utils
    from oryx_tpu_torch.app.classreg import example_from_tokens
    from oryx_tpu_torch.app.rdf import pmml as rdf_pmml
    from oryx_tpu_torch.app.rdf import update as rdf_update
    from oryx_tpu_torch.kafka import utils as kafka_utils
    from oryx_tpu_torch.kafka.inproc import InProcTopicProducer, \
        resolve_broker
    from oryx_tpu_torch.lambda_rt.batch import BatchLayer
    from oryx_tpu_torch.lambda_rt.serving import ServingLayer
    from oryx_tpu_torch.lambda_rt.speed import SpeedLayer

    label = "rdf_loop"
    cfg = rdf_loop_config(work_dir)
    broker_uri = cfg.get_string("oryx.input-topic.broker")
    broker = resolve_broker(broker_uri)
    in_topic = cfg.get_string("oryx.input-topic.message.topic")
    up_topic = cfg.get_string("oryx.update-topic.message.topic")
    rng = np.random.default_rng(RLOOP_SEED)
    kafka_utils.maybe_create_topic(
        broker_uri, in_topic,
        partitions=kafka_utils.input_topic_partitions(cfg))
    InProcTopicProducer(broker_uri, in_topic).send_many(
        [(None, line, None) for line in covtype_lines(rng, RLOOP_LINES)])

    batch = BatchLayer(cfg, device=DEVICE)
    cls = rdf_update.RDFUpdate
    with timed_calls({"parse_s": (cls, "_parse"),
                      "encodings_s": (cls, "_encodings_from"),
                      "matrices_s": (cls, "_to_matrices"),
                      "train_s": (rdf_update, "train_forest"),
                      "pmml_s": (rdf_update.rdf_pmml, "forest_to_pmml"),
                      "evaluate_s": (cls, "evaluate")}) as stages:
        t0 = time.perf_counter()
        batch.run_one_generation()
        generation_s = time.perf_counter() - t0
    stages = {k: v for k, v in stages.items() if not k.endswith("_calls")}
    stages["other_s"] = generation_s - sum(stages.values())
    check(broker.get_offsets(batch._group, in_topic)
          == broker.latest_offsets(in_topic),
          f"{label}: the generation did not commit its offsets")
    ends = broker.latest_offsets(up_topic)
    published = broker.read_ranges(up_topic, [0] * len(ends), ends)
    check(len(published) == 1 and published[0].key in ("MODEL", "MODEL-REF"),
          f"{label}: the generation published {[m.key for m in published]}")
    doc = pmml_utils.read_pmml_from_update_key_message(
        published[0].key, published[0].message)
    forest, encodings = rdf_pmml.read_forest(doc)
    check(len(forest.trees) == cfg.get_int("oryx.rdf.num-trees"),
          f"{label}: {len(forest.trees)} trees")
    depth = max(len(n.id) - 1 for t in forest.trees for n in t.nodes())
    check(depth <= cfg.get_int("oryx.rdf.hyperparams.max-depth"),
          f"{label}: a tree of depth {depth}")
    schema = batch.update_instance.input_schema
    target = schema.target_feature_index

    def host_walk(tokens):
        return forest.predict(example_from_tokens(tokens, schema, encodings))

    serving = ServingLayer(cfg, port=0, device=DEVICE)
    speed = SpeedLayer(cfg, device=DEVICE)
    t0 = time.perf_counter()
    serving.start()
    speed.start()
    try:
        smgr, pmgr = serving.model_manager, speed.model_manager
        wait_for(lambda: http_call(serving.port, "GET", "/ready")[0] == 204,
                 f"{label}: /ready", LOOP_WAIT_S)
        serving_load_s = time.perf_counter() - t0
        wait_for(lambda: pmgr.model is not None, f"{label}: the speed load",
                 LOOP_WAIT_S)
        speed_load_s = time.perf_counter() - t0

        # /predict: GET (the host walk) and POST (the forest walk on the
        # card) against the host walk of the PMML read back
        probes = covtype_lines(rng, RLOOP_PROBES, labeled=False)
        want, ties = [], []
        for line in probes:
            probs = host_walk(line.split(",")).category_probabilities
            top2 = np.sort(probs)[-2:]
            ties.append(top2[1] - top2[0] <= 1e-6)
            want.append(encodings.decode(target, int(np.argmax(probs))))
        get_ms = []
        for line, w, tie in zip(probes, want, ties):
            status, body, ms = http_call(serving.port, "GET",
                                         f"/predict/{line}")
            get_ms.append(ms)
            check(status == 200 and (json.loads(body) == w or tie),
                  f"{label}: /predict/{line} answered {status} {body!r}, "
                  f"the host walk {w}")
        post_ms, got = [], None
        for _ in range(RLOOP_POSTS):
            status, body, ms = http_call(serving.port, "POST", "/predict",
                                         "\n".join(probes).encode())
            check(status == 200, f"{label}: POST /predict answered {status}")
            post_ms.append(ms)
            got = json.loads(body)
        check(len(got) == len(want) and all(
            g == w or tie for g, w, tie in zip(got, want, ties)),
            f"{label}: POST /predict differs from the host walk off a tie")

        # /classificationDistribution and /feature/importance
        def distribution(line):
            status, body, _ = http_call(serving.port, "GET",
                                        f"/classificationDistribution/{line}")
            check(status == 200, f"{label}: /classificationDistribution/"
                  f"{line} answered {status}")
            return {d["id"]: d["value"] for d in json.loads(body)}

        def host_distribution(line):
            probs = host_walk(line.split(",")).category_probabilities
            return {encodings.decode(target, i): float(p)
                    for i, p in enumerate(probs)}

        dist_probes = probes[:RLOOP_DIST_PROBES]
        before = {line: distribution(line) for line in dist_probes}
        for line in dist_probes:
            check(before[line] == host_distribution(line),
                  f"{label}: /classificationDistribution/{line} differs "
                  f"from the host forest")
        status, body, _ = http_call(serving.port, "GET", "/feature/importance")
        imps = [float(forest.feature_importances[
            schema.predictor_to_feature_index(p)])
            for p in range(schema.num_predictors)]
        check(status == 200 and json.loads(body) == imps,
              f"{label}: /feature/importance {body!r}, the host's {imps}")
        for p in range(schema.num_predictors):
            status, body, _ = http_call(serving.port, "GET",
                                        f"/feature/importance/{p}")
            check(status == 200 and json.loads(body) == imps[p],
                  f"{label}: /feature/importance/{p} {body!r}")

        # /train onto the input topic, then one speed micro-batch
        broker.set_offsets(speed._group, in_topic,
                           broker.latest_offsets(in_topic))
        in_before = broker.latest_offsets(in_topic)
        train = covtype_lines(rng, RLOOP_TRAIN)
        t0 = time.perf_counter()
        for line in train[:8]:
            check(http_call(serving.port, "POST", f"/train/{line}",
                            b"")[0] == 204, f"{label}: /train/{line}")
        check(http_call(serving.port, "POST", "/train",
                        "\n".join(train[8:]).encode())[0] == 204,
              f"{label}: POST /train")
        t_last_train = time.perf_counter()
        train_s = t_last_train - t0
        new = broker.read_ranges(in_topic, in_before,
                                 broker.latest_offsets(in_topic))
        check(sorted(m.message for m in new) == sorted(train),
              f"{label}: {len(new)} input records for {len(train)} trained")
        up_before = broker.latest_offsets(up_topic)
        t0 = time.perf_counter()
        speed.run_one_micro_batch()
        micro_batch_s = time.perf_counter() - t0
        ups = [json.loads(m.message) for m in broker.read_ranges(
            up_topic, up_before, broker.latest_offsets(up_topic))]
        # the NumPy recount of the host walk: per tree, per terminal node,
        # the class counts of the micro-batch's examples
        expect: dict = {}
        for line in (m.message for m in new):
            ex = example_from_tokens(line.split(","), schema, encodings)
            if ex.target is None:
                continue
            for t, tree in enumerate(forest.trees):
                counts = expect.setdefault(
                    (t, tree.find_terminal(ex).id),
                    np.zeros(encodings.get_value_count(target), np.int64))
                counts[int(ex.target)] += 1
        got_ups = {(u[0], u[1]): u[2] for u in ups}
        check(len(got_ups) == len(ups) == len(expect) and all(
            {str(i): int(c) for i, c in enumerate(expect[key]) if c}
            == got_ups.get(key) for key in expect),
            f"{label}: {len(ups)} UP records differ from the recount of the "
            f"host walk ({len(expect)} nodes)")
        # the serving layer then holds them: apply them to the host forest
        for (t, node_id), counts in got_ups.items():
            leaf = forest.trees[t].find_by_id(node_id)
            for enc, c in counts.items():
                leaf.prediction.update(int(enc), int(c))

        def applied():
            trees = smgr.get_model().forest.trees
            return all(trees[t].find_by_id(node_id).prediction.count
                       == forest.trees[t].find_by_id(node_id).prediction.count
                       for t, node_id in got_ups)

        wait_for(applied, f"{label}: serving to apply the UPs", LOOP_WAIT_S)
        applied_ms = (time.perf_counter() - t_last_train) * 1e3
        moved_probes = 0
        for line in dist_probes:
            after = distribution(line)
            check(after == host_distribution(line),
                  f"{label}: /classificationDistribution/{line} after the "
                  f"UPs differs from the updated host forest")
            moved_probes += after != before[line]
        check(moved_probes > 0, f"{label}: no /classificationDistribution "
              f"probe moved with the UPs")
        status, body, _ = http_call(serving.port, "POST", "/predict",
                                    "\n".join(dist_probes).encode())
        check(status == 200, f"{label}: POST /predict after the UPs")
        for line, g in zip(dist_probes, json.loads(body)):
            probs = host_walk(line.split(",")).category_probabilities
            top2 = np.sort(probs)[-2:]
            w = encodings.decode(target, int(np.argmax(probs)))
            check(g == w or top2[1] - top2[0] <= 1e-6,
                  f"{label}: POST /predict after the UPs: {g}, host {w}")
        moved = sum(int(c.sum()) for c in expect.values())
    finally:
        speed.close()
        serving.close()
    check(not serving.consuming and not speed.consuming,
          f"{label}: a consumer outlived close()")
    line = {"phase": "rdf_loop", "lines": RLOOP_LINES,
            "trees": len(forest.trees), "max_depth": depth,
            "nodes": sum(len(list(t.nodes())) for t in forest.trees),
            "published": published[0].key, "generation_s": generation_s,
            "generation_stages_s": stages, "serving_load_s": serving_load_s,
            "speed_load_s": speed_load_s, "predict_checked": len(probes),
            "predict_get_p50_ms": statistics.median(get_ms),
            "predict_post_rows": len(probes),
            "predict_post_p50_ms": statistics.median(post_ms),
            "near_ties": int(sum(ties)), "trained": len(train),
            "train_s": train_s, "micro_batch_s": micro_batch_s,
            "up_records": len(ups), "up_counts": moved,
            "moved_probes": moved_probes,
            "train_to_served_ms": applied_ms}
    log(line)
    return line


# -- phase 8: the benches and the probe kernels -----------------------------

def held_kernel(kernel: str, label: str, M, R, zero_rows: int,
                fields: dict) -> float:
    """Hold a bf16 phase-A kernel's maxima ``M`` against the plain
    version's ``R`` (``compare``: the -inf pattern, no NaN, rtol 1e-4;
    the last ``zero_rows`` queries zero) and log the case; the largest
    absolute error."""
    import torch
    info = " ".join(f"{k}={v}" for k, v in {"label": label,
                                             **fields}.items())
    err, _ = compare(kernel, info, M, R, False, RTOL["bfloat16"], zero_rows)
    log({"phase": "kernel_check", "kernel": kernel, "label": label,
         **fields, "max_abs_err": err,
         "masked": int((~torch.isfinite(R)).sum())})
    return err


def qm_inputs(rows: int, width: int, batch: int):
    """The probes' inputs (``lsh_mask_probe.make_inputs``'s draws) at
    ``rows`` x ``width``, with every 11th row and block 5 retired."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    Y = torch.randn((rows, width), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    Qc = torch.randn((batch, width), generator=gen, device=DEVICE,
                     dtype=torch.bfloat16)
    pen = torch.zeros((rows // 128, 128), dtype=torch.float32, device=DEVICE)
    pen.view(-1)[::11] = float("-inf")
    pen[5] = float("-inf")
    bkt = torch.randint(0, 128, (rows,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    tgt = torch.randint(0, 128, (batch,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    return Y, Qc, pen, bkt, tgt


def window(Qc, b: int):
    """The first ``b`` queries, the last eighth zero, as a window padded
    past its requests is."""
    q = Qc[:b].clone()
    q[b - b // 8:] = 0
    return q


def qm_cases(Y, Qc, pen, bkt, tgt, windows, label: str,
             timed: bool = False) -> float:
    """``phase_a_qm`` against its plain version at each window, exact and
    LSH; the largest absolute error.  Each case also says which
    instantiation ran, its registers and spills (from the compiler's
    output); with ``timed``, the kernel's time and bound there."""
    from oryx_tpu_torch.bench.diag.lsh_mask_probe import MB
    from oryx_tpu_torch.bench.kernel_probe import bound, time_exec
    from oryx_tpu_torch.ops import phase_a as pa
    from oryx_tpu_torch.ops import phase_a_qm as qm
    n, width = Y.shape
    worst = 0.0
    for b in windows:
        q = window(Qc, b)
        for lsh in (False, True):
            plan = qm.plan(width, b, lsh)
            args = (bkt, tgt[:b], MB) if lsh else (None, None, 0)
            M = qm.phase_a_qm(q, Y, pen, *args)
            R = pa.phase_a_reference(q, Y, pen, *args)
            # the compiler's counts where this process built the library,
            # else the kernel's attributes (plan)
            usage = ptxas_usage("phase_a_qm.cu", plan["variant"])
            fields = {"rows": n, "width": width, "B": b, "lsh": lsh, **plan,
                      **{k: v for k, v in usage.items() if v is not None}}
            if timed:
                nbytes = (n * width * 2 + b * width * 2 + n * 4
                          + b * (n // 128) * 4 + (n * 4 + b * 4 if lsh
                                                   else 0))
                fields["ms"] = time_exec(
                    lambda: qm.phase_a_qm(q, Y, pen, *args), m=4,
                    min_delta_ms=20.0)["exec_ms"]
                fields.update(bound(nbytes, 2.0 * n * width * b, Y.device))
            worst = max(worst, held_kernel("phase_a_qm", label, M, R, b // 8,
                                           fields))
            del M, R
    return worst


def probe_checks() -> dict:
    """Phase 8a: the largest error of ``phase_a_qm`` over its windows
    and coverage shapes, and of ``phase_a`` at the probes' shapes (the
    LSH and exact bodies of kernels 5 and 7, the small-feature stores of
    kernel 8)."""
    import torch
    from oryx_tpu_torch.bench.diag import lsh_mask_probe, smallf_probe
    from oryx_tpu_torch.ops import phase_a as pa
    rows = int(PROBE_ITEMS_M * 1e6) // lsh_mask_probe.T * lsh_mask_probe.T
    Y, Qc, pen, bkt, tgt = qm_inputs(rows, lsh_mask_probe.W,
                                     max(QM_WINDOWS))
    errs = {"phase_a_qm": qm_cases(Y, Qc, pen, bkt, tgt, QM_WINDOWS,
                                   "probe_head", timed=True)}
    q = window(Qc, 256)
    for lsh, key in ((True, "lsh"), (False, "exact")):
        args = (bkt, tgt[:256], lsh_mask_probe.MB) if lsh else (None, None, 0)
        errs[key] = held_kernel(
            "phase_a", "probe_head", pa.phase_a(q, Y, pen, *args),
            pa.phase_a_reference(q, Y, pen, *args), 256 // 8,
            {"rows": rows, "width": lsh_mask_probe.W, "B": 256, "lsh": lsh})
    del Y, Qc, pen, bkt, tgt
    free()
    for width in QM_COVERAGE_WIDTHS:
        Y, Qc, pen, bkt, tgt = qm_inputs(COVERAGE_ROWS, width,
                                         max(QM_COVERAGE_WINDOWS))
        errs["phase_a_qm"] = max(errs["phase_a_qm"], qm_cases(
            Y, Qc, pen, bkt, tgt, QM_COVERAGE_WINDOWS, "coverage",
            timed=True))
        del Y, Qc, pen, bkt, tgt
    free()
    n = int(PROBE_ITEMS_M * 1e6) // smallf_probe.ROW_ALIGN \
        * smallf_probe.ROW_ALIGN
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    for f in (50, 250):
        Y, Q, _, penalty, _ = smallf_probe.make_inputs(n, f, 256, DEVICE, gen)
        errs[f"F{f}"] = held_kernel(
            "phase_a", "smallf", smallf_probe.phase_a(Y, Q, penalty),
            pa.phase_a_reference(Q, Y, penalty), 0,
            {"rows": n, "width": Y.shape[1], "features": f, "B": 256,
             "lsh": False})
        del Y, Q, penalty
        free()
    return errs


def grid_cell(card_peaks: dict) -> list[dict]:
    """One short grid cell (``bench.grid.bench_config``) at 1M x 50 bf16,
    LSH off and on; while each mode's server runs, the answers for 32
    sampled users must equal the model's top-k with the plain phase-A
    versions."""
    from oryx_tpu_torch.bench import grid
    rng = np.random.default_rng(GRID_SEED)
    model, users = grid.build_model(GRID_FEATURES, GRID_ITEMS, rng,
                                    device=DEVICE)
    checked = []

    def answers(base: str, lsh_on: bool) -> None:
        port = int(base.rsplit(":", 1)[1])
        picks = rng.choice(len(users), GRID_CHECK_USERS, replace=False)
        Q = np.stack([model.get_user_vector(users[j]) for j in picks])
        want, _ = reference_top_n_batch(model, 10, Q,
                                        [set()] * GRID_CHECK_USERS)
        for j, w in zip(picks, want):
            status, body, _ = http_call(port, "GET",
                                        f"/recommend/{users[j]}?howMany=10")
            check(status == 200, f"grid cell: /recommend/{users[j]} gave "
                  f"{status}")
            got = [(d["id"], d["value"]) for d in json.loads(body)]
            same_answers(got, w, RTOL["bfloat16"],
                         f"grid cell lsh={lsh_on} /recommend/{users[j]}")
        checked.append(lsh_on)

    rows = grid.bench_config(GRID_FEATURES, GRID_ITEMS / 1e6, model, users,
                             peaks=card_peaks, on_served=answers,
                             log=lambda line: None, **GRID_RUNGS)
    check(checked == [False, True], f"grid cell: answers checked {checked}")
    for r in rows:
        log({"phase": "grid_cell", **{k: r[k] for k in (
            "features", "items", "lsh", "open_loop_sustained_qps",
            "sustained_p50_ms", "sustained_p99_ms", "qps", "sat_requests",
            "p50_ms_saturated", "p99_ms_saturated", "p50_ms_at_2_workers",
            "device_exec_ms", "window_ms", "host_ms", "dispatch_floor_ms",
            "kernel_path", "twophase_fallbacks", "batcher")}})
    del model
    free()
    return rows


def bench_phase() -> list[dict]:
    """Phase 8: the probe kernels against their plain versions, then,
    with every count at 0, the probes, the card's peaks and one grid
    cell; the ``kernels`` entries of phase_a_qm and of the probe rows
    (kernels 5-8)."""
    from oryx_tpu_torch.bench import grid
    from oryx_tpu_torch.bench.diag import lsh_mask_probe, smallf_probe
    from oryx_tpu_torch.bench.kernel_probe import measure_peaks
    from oryx_tpu_torch.ops import phase_a_qm as qm
    t0 = time.perf_counter()
    errs = probe_checks()
    t_checks = time.perf_counter() - t0

    reset_launches()
    lines = {r["variant"]: r for r in lsh_mask_probe.run(
        PROBE_ITEMS_M, 256, DEVICE,
        log=lambda r: log({"phase": "lsh_mask_probe", **r}))}
    free()
    small = smallf_probe.run(PROBE_ITEMS_M, (50, 250), 256, DEVICE,
                             log=lambda r: log({"phase": "smallf_probe",
                                                **r}))["results"]
    free()
    card_peaks = measure_peaks(device=DEVICE)
    floor = grid.measure_dispatch_floor(DEVICE)
    log({"phase": "peaks", **card_peaks, "dispatch_floor_ms": floor})
    grid_cell(card_peaks)
    launches = read_launches()
    check(launches["phase_a_qm"] > 0 and launches["phase_a"] > 0,
          f"phase 8: a probe kernel launched no time: {launches}")
    log({"phase": "bench", "launches": launches, "checks_s": t_checks,
         "seconds": time.perf_counter() - t0})

    def entry(name, wrapper, replaces, line, err, shape):
        return {"name": name, "route": "cuda",
                "source": KERNELS[wrapper][1], "replaces": replaces,
                "launches": line["launches"], "max_abs_err": err,
                "ms": line["exec_ms"], "plain_ms": line["plain_ms"],
                "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
                "library_ms": line["library_ms"], "served_config": None,
                "shape": shape}

    head = {"rows": lines["exact_floor"]["rows"], "width": lsh_mask_probe.W,
            "B": 256, "store": "bfloat16"}
    qm_line = lines["mask_2d_transposed"]
    design = qm.plan(lsh_mask_probe.W, 256, True)
    out = [{**entry("phase_a_qm", "phase_a_qm", KERNELS["phase_a_qm"][0],
                    qm_line, errs["phase_a_qm"], {**head, "lsh": True}),
            "launches": launches["phase_a_qm"], "body": "wgmma",
            "variant": design["variant"], "registers": design["registers"],
            "spill_bytes": design["local_bytes"],
            **{k: v for k, v in ptxas_usage(
                "phase_a_qm.cu", design["variant"]).items() if v is not None}}]
    for variant, err in (("mask_3d_current", errs["lsh"]),
                         ("exact_floor", errs["exact"])):
        line = lines[variant]
        out.append(entry(f"phase_a ({variant})", "phase_a", line["replaces"],
                         line, err, {**head, "lsh": line["lsh"]}))
    for f in (50, 250):
        rec = small[f"F{f}"]
        out.append({**entry(
            f"phase_a (smallf F{f})", "phase_a", rec["replaces"],
            rec["phase_a"], errs[f"F{f}"],
            {"rows": rec["N"], "width": rec["stored_width"], "features": f,
             "B": 256, "store": "bfloat16", "lsh": False}),
            "bound_ms_logical": rec["phase_a"]["bound_ms_logical"]})
    return out


# -- phase 9: the operator entry point ---------------------------------------

def cli_env() -> dict:
    """The environment of a command run from the checkout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def device_args() -> list[str]:
    """The commands' device flag: none, the card, unless ``DEVICE`` is
    another."""
    return [] if DEVICE == "cuda" else ["--device", DEVICE]


def run_module(args: list[str], what: str, timeout: float) -> tuple:
    """(last stdout line as JSON, wall seconds) of ``python -m args``
    run from the checkout; fails the run unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args, *device_args()],
                          cwd=REPO,
                          env=cli_env(), capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"deploy: {what} exited {proc.returncode}:"
          f"\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), wall


def deploy_warmup(conf: str, run: int) -> dict:
    """``python -m oryx_tpu_torch warmup`` over the deploy ladder."""
    report, wall = run_module(
        ["oryx_tpu_torch", "warmup", "--conf", conf, "--items", DEPLOY_ITEMS,
         "--features", DEPLOY_FEATURES, "--verbose"], f"warmup {run}", 600)
    check(report["compiled_count"] > 0,
          f"deploy: warmup {run} compiled nothing")
    # a width limit is the one refusal the ladder may meet
    check(all("kernel needs" in f["error"] for f in report["failed"]),
          f"deploy: warmup {run} failed: {report['failed']}")
    statuses: dict = {}
    for e in report["compiled"]:
        statuses[e["status"]] = statuses.get(e["status"], 0) + 1
    log({"phase": "deploy_warmup", "run": run, "process_s": wall,
         "wall_s": report["wall_s"], "build_s": report["build_s"],
         "nvcc_runs": report["nvcc_runs"],
         "compiled": report["compiled_count"],
         "failed": report["failed_count"], "plain": len(report["plain"]),
         "statuses": statuses, "device": report["device"],
         "libraries": sorted({e["library"] for e in report["compiled"]})})
    return report


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def log_match(path: str, pattern: str) -> list:
    with open(path, encoding="utf-8", errors="replace") as f:
        return re.findall(pattern, f.read())


def deploy_serve(publisher, work_dir: str, cache: str) -> dict:
    """``python -m oryx_tpu_torch serving`` off a file:// update topic:
    its answers against the same model in this process on the plain
    phase-A versions, its route a kernel kind, its exit on SIGINT."""
    import torch
    from oryx_tpu_torch.app.als import slices
    from oryx_tpu_torch.common.config import from_file
    from oryx_tpu_torch.kafka.inproc import InProcTopicProducer

    label = "deploy_1M_50f_f32_lsh0.3"
    model_dir = os.path.join(work_dir, "model")
    publisher.join(TOPIC_WAIT_S)
    check(publisher.exitcode == 0,
          f"{label}: publishing the model failed ({publisher.exitcode})")
    with open(os.path.join(model_dir, "published.json"),
              encoding="utf-8") as f:
        published = json.load(f)
    Y, X, known = topic_data(TOPIC_SEED)
    broker = "file://" + os.path.join(work_dir, "deploy_broker")
    port = free_port()
    conf = os.path.join(work_dir, "deploy_serving.conf")
    with open(os.path.join(REPO, "oryx_tpu_torch", "conf",
                           "als-example.conf"), encoding="utf-8") as f:
        text = f.read()
    with open(conf, "w", encoding="utf-8") as f:
        f.write(text + "\n" + "\n".join(
            f"{k} = {json.dumps(v)}" for k, v in {
                "oryx.update-topic.broker": broker,
                "oryx.input-topic.broker": broker,
                "oryx.als.sample-rate": LSH_RATE,
                "oryx.serving.api.port": port,
                "oryx.compile-cache-dir": cache}.items()) + "\n")
    topic = from_file(conf).get_string("oryx.update-topic.message.topic")
    producer = InProcTopicProducer(broker, topic)
    producer.send("MODEL-REF", slices.model_ref_message(
        os.path.join(model_dir, "model.pmml.xml"), model_dir,
        published["manifest"]))
    for u in range(N_USERS):
        producer.send("UP", json.dumps(
            ["X", f"u{u}", [float(v) for v in X[u]], known[f"u{u}"]]))
    producer.close()

    log_path = os.path.join(work_dir, "deploy_serving.log")
    t0 = time.perf_counter()
    with open(log_path, "w", encoding="utf-8") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "oryx_tpu_torch", "serving", "--conf",
             conf, *device_args()], cwd=REPO, env=cli_env(), stdout=log_f,
            stderr=subprocess.STDOUT)
    try:
        def ready() -> bool:
            check(proc.poll() is None,
                  f"{label}: the serving process exited {proc.returncode}")
            try:
                status, _, _ = http_call(port, "GET", "/ready")
            except OSError:
                return False
            return status == 204 and bool(log_match(
                log_path, r"chosen=(\w+) use_lsh=(\w+)"))

        wait_for(ready, f"{label}: /ready and the route", DEPLOY_WAIT_S)
        ready_s = time.perf_counter() - t0
        last = f"u{N_USERS - 1}"
        wait_for(lambda: http_call(port, "GET", f"/knownItems/{last}")[0]
                 == 200, f"{label}: the UP records", DEPLOY_WAIT_S)
        users = [f"u{DEPLOY_USERS + j}" for j in range(DEPLOY_REQUESTS)]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            results = list(pool.map(
                lambda u: http_call(port, "GET",
                                    f"/recommend/{u}?howMany=10"), users))
        routes = log_match(log_path, r"chosen=(\w+) use_lsh=(\w+) .*"
                           r"launches=(\{[^}]*\})")
        check(len(routes) == 1, f"{label}: {len(routes)} routes measured")
        kind, use_lsh, route_launches = routes[0]
        route_launches = json.loads(route_launches)
        use_lsh = use_lsh == "True"
        check(kind in KERNEL_KINDS,
              f"{label}: the served route chose {kind!r}, not a kernel kind")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(60)
        check(rc == 0, f"{label}: exit {rc} on SIGINT")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    with open(log_path, encoding="utf-8", errors="replace") as f:
        print(f"--- {label}: the serving process's log\n{f.read()[-20000:]}",
              file=sys.stderr)
    exits = log_match(log_path, r"serving: kernel launches=(\{[^}]*\})")
    check(len(exits) == 1, f"{label}: no launch line at exit")
    served = {k: v - route_launches[k]
              for k, v in json.loads(exits[0]).items()}
    expected = next(k for k, v in KERNELS.items() if v[2] == kind)
    check(served[expected] > 0,
          f"{label}: {expected} launched no time: {served}")
    check(all(v == 0 for k, v in served.items() if k != expected),
          f"{label}: another kernel than {expected} launched: {served}")

    # the same model in this process, its phase-A kernels swapped for
    # their plain versions (every kind answers the exact top-k of what
    # its mask admits); the LSH hyperplanes are drawn per process, so an
    # LSH route is held to its scores, not its ids
    model = build_model(TOPIC_FEATURES, Y, X, known, "float32",
                        sample_rate=LSH_RATE if use_lsh else 1.0)
    Q = np.stack([X[int(u[1:])] for u in users])
    excl = [set(known[u]) for u in users]
    want, _ = reference_top_n_batch(model, 10, Q, excl)
    for u, (status, body, _), w in zip(users, results, want):
        check(status == 200, f"{label}: /recommend/{u} gave {status}")
        got = [(d["id"], d["value"]) for d in json.loads(body)]
        check(len(got) == 10 and all(np.isfinite(v) for _, v in got),
              f"{label}: /recommend/{u} gave {got}")
        if not use_lsh:
            same_answers(got, w, RTOL["float32"], f"{label} /recommend/{u}")
        else:
            dots = Y[[int(i[1:]) for i, _ in got]] @ X[int(u[1:])]
            np.testing.assert_allclose([v for _, v in got], dots, rtol=1e-5,
                                       err_msg=f"{label} /recommend/{u}")
            check(not excl[users.index(u)] & {i for i, _ in got},
                  f"{label}: /recommend/{u} gave a known item")
    del model
    free()
    lat = sorted(r[2] for r in results)
    line = {"phase": "deploy_serve", "config": label, "kind": kind,
            "use_lsh": use_lsh, "ready_s": ready_s,
            "requests": len(results), "launches": served,
            "route_launches": route_launches,
            "p50_ms": lat[len(lat) // 2], "max_ms": lat[-1],
            "exit": rc, "held": "ids and scores" if not use_lsh
            else "scores"}
    log(line)
    torch.cuda.synchronize()
    return line


def deploy_phase(publisher, work_dir: str) -> dict:
    """Phase 9: warmup into a fresh cache twice, serving from the entry
    point, and the cold-start bench, each in processes of its own."""
    from oryx_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cache = os.path.join(work_dir, "deploy_cache")
    conf = os.path.join(work_dir, "deploy_warmup.conf")
    with open(conf, "w", encoding="utf-8") as f:
        f.write(f"oryx.compile-cache-dir = {json.dumps(cache)}\n")
    first = deploy_warmup(conf, 1)
    built = set(os.listdir(os.path.join(cache, "kernels")))
    missing = [src.name for src in cuda_build.SOURCES
               if cuda_build.library_path(src).name not in built]
    check(not missing, f"deploy: warmup built no library of {missing}")
    check(first["nvcc_runs"] == len(cuda_build.SOURCES),
          f"deploy: warmup 1 ran nvcc {first['nvcc_runs']} times")
    # the second warmup and the cold-start bench run beside the served
    # process, whose load they overlap (their seconds are taken on a
    # busy host); the served process finds warmup 1's libraries
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        again = pool.submit(deploy_warmup, conf, 2)
        coldstart = pool.submit(run_module, [
            "oryx_tpu_torch.bench.coldstart", "--ratings", str(COLD_RATINGS),
            "--rank", str(COLD_RANK),
            "--cache-dir", os.path.join(work_dir, "coldstart_cache")],
            "coldstart", 600)
        serve = deploy_serve(publisher, work_dir, cache)
        second = again.result()
        cold, wall = coldstart.result()
    check(second["nvcc_runs"] == 0 and all(
        e["status"] == "found current" for e in second["compiled"]),
        "deploy: warmup 2 built a library again")
    log({"phase": "deploy_coldstart", "process_s": wall,
         "beside_serving": True, **cold})
    log({"phase": "deploy", "seconds": time.perf_counter() - t0})
    return serve


# -- phase 10: the observability surface -------------------------------------

def obs_config(work_dir: str):
    """Phase 10's config: the port's example config with every obs key
    on, on a file:// broker and directories of its own."""
    from oryx_tpu_torch.common.config import from_file, overlay_on
    obs = os.path.join(work_dir, "obs")
    broker = "file://" + os.path.join(obs, "broker")
    return overlay_on({
        "oryx.update-topic.broker": broker,
        "oryx.input-topic.broker": broker,
        "oryx.als.sample-rate": LSH_RATE,
        "oryx.obs.tracing.enabled": True,
        "oryx.obs.tracing.sample-ratio": 1.0,
        "oryx.obs.tracing.max-traces": 4 * OBS_REQUESTS,
        "oryx.obs.slo.enabled": True,
        "oryx.obs.slo.objectives": {
            "availability": {"kind": "availability", "target": 0.999},
            "latency": {"kind": "latency", "target": 0.99,
                        "threshold-ms": 500}},
        "oryx.obs.events.dir": os.path.join(obs, "events"),
        "oryx.obs.flight.dir": os.path.join(obs, "flight"),
        "oryx.obs.flight.dump-on-exit": False,
        # every trigger dumps: the manual dump is never debounced away
        "oryx.obs.flight.debounce-sec": 0.0,
        "oryx.obs.profile-dir": os.path.join(obs, "profile"),
    }, from_file(os.path.join(REPO, "oryx_tpu_torch", "conf",
                              "als-example.conf")))


def traced_call(port: int, method: str, path: str):
    """(status, body, milliseconds, X-Oryx-Trace id or None) of one
    request on a new connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, headers={"Accept": "application/json"})
        resp = conn.getresponse()
        out = resp.read()
        return (resp.status, out, (time.perf_counter() - t0) * 1e3,
                resp.getheader("X-Oryx-Trace"))
    finally:
        conn.close()


def percentiles(times_ms) -> dict:
    lat = sorted(times_ms)
    return {"p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))]}


def kernel_symbols(wrapper: str) -> list[str]:
    """The ``__global__`` functions of a wrapper's CUDA source."""
    with open(os.path.join(REPO, KERNELS[wrapper][1]),
              encoding="utf-8") as f:
        return re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                          r"\([^)]*\)\s*)?(\w+)\s*\(", f.read())


def profile_kernels(trace_file: str, symbols: list[str],
                    window_ms: float) -> dict:
    """Kernel events of an ``/admin/profile`` Chrome trace: how many
    name one of ``symbols``, and the card's busy share over the capture
    window (the union of every kernel event's interval)."""
    with open(trace_file, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    pattern = re.compile(r"\b(" + "|".join(symbols) + r")\b")
    routed = [e for e in kernels if pattern.search(e.get("name", ""))]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in kernels):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    names = sorted({pattern.search(e["name"]).group(1) for e in routed})
    return {"kernel_events": len(kernels), "routed_events": len(routed),
            "routed_symbols": names, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / window_ms}


def obs_start(publisher, work_dir: str) -> dict:
    """Phase 10's ServingLayer, started and sent phase 4's model and UP
    records before phase 9, so that its load overlaps phase 9's
    processes; ``obs_phase`` takes it from there (and closes it)."""
    from oryx_tpu_torch.app.als import slices
    from oryx_tpu_torch.kafka.inproc import InProcTopicProducer
    from oryx_tpu_torch.lambda_rt.serving import ServingLayer

    t_phase = time.perf_counter()
    model_dir = os.path.join(work_dir, "model")
    publisher.join(TOPIC_WAIT_S)
    check(publisher.exitcode == 0,
          f"obs: publishing the model failed ({publisher.exitcode})")
    with open(os.path.join(model_dir, "published.json"),
              encoding="utf-8") as f:
        published = json.load(f)
    _, X, known = topic_data(TOPIC_SEED)
    cfg = obs_config(work_dir)
    free()
    layer = ServingLayer(cfg, port=0)
    # the load's /ready polls stay unsampled: the ring keeps the bursts
    layer.tracer.sample_ratio = 0.0
    try:
        layer.start()
        producer = InProcTopicProducer(
            cfg.get_string("oryx.update-topic.broker"),
            cfg.get_string("oryx.update-topic.message.topic"))
        producer.send("MODEL-REF", slices.model_ref_message(
            os.path.join(model_dir, "model.pmml.xml"), model_dir,
            published["manifest"]))
        for u in range(N_USERS):
            producer.send("UP", json.dumps(
                ["X", f"u{u}", [float(v) for v in X[u]], known[f"u{u}"]]))
        producer.close()
    except BaseException:
        layer.close()
        raise
    return {"layer": layer, "cfg": cfg, "X": X, "known": known,
            "sent_at": time.perf_counter(),
            "start_s": time.perf_counter() - t_phase}


def obs_phase(started: dict, topic: dict | None) -> dict:
    """Phase 10: a ServingLayer from the example config with every obs
    key on, over phase 4's model (``obs_start``); its answers, /metrics,
    traces, tail, profile, event log and flight recorder; the cost of
    observability."""
    import torch
    from oryx_tpu_torch.bench import obs_overhead
    from oryx_tpu_torch.obs import anatomy
    from oryx_tpu_torch.obs.device_time import _label

    label = "1M_50f_f32_lsh0.3_topic"
    t_phase = time.perf_counter()
    layer, cfg = started["layer"], started["cfg"]
    X, known = started["X"], started["known"]
    try:
        port, mgr = layer.port, layer.model_manager
        last = f"u{N_USERS - 1}"
        wait_for(lambda: http_call(port, "GET", "/ready")[0] == 204
                 and mgr.get_model()._route is not None
                 and mgr.get_model().get_known_items(last)
                 == set(known[last]),
                 "obs: /ready, the route and the UP records", TOPIC_WAIT_S)
        ready_waited_s = time.perf_counter() - t_phase
        load_s = mgr.model_load_s
        model = mgr.get_model()
        kind = routed_kind(model)
        check(kind in KERNEL_KINDS, f"obs: the route chose {kind!r}")
        expected = next(k for k, v in KERNELS.items() if v[2] == kind)
        route_label = model.kernel_route_label
        users = [f"u{u}" for u in range(OBS_REQUESTS)]
        paths = [f"/recommend/{u}?howMany=10" for u in users]

        def burst(ratio: float) -> list:
            layer.tracer.sample_ratio = ratio
            with concurrent.futures.ThreadPoolExecutor(OBS_CLIENTS) as pool:
                out = list(pool.map(
                    lambda p: traced_call(port, "GET", p), paths))
            for path, (status, body, _, _) in zip(paths, out):
                check(status == 200,
                      f"obs: {path} gave {status}: {body[:300]}")
            return out

        burst(1.0)  # untimed: the batcher learns its pacing
        unsampled = burst(0.0)
        check(all(r[3] is None for r in unsampled),
              "obs: an unsampled response carried X-Oryx-Trace")
        torch.cuda.synchronize()
        reset_launches()
        sampled = burst(1.0)
        launches = read_launches()
        check(launches[expected] > 0,
              f"obs: {expected} launched no time: {launches}")
        check(all(v == 0 for k, v in launches.items() if k != expected),
              f"obs: another kernel than {expected} launched: {launches}")
        trace_ids = [r[3] for r in sampled]
        check(all(t and re.fullmatch(r"[0-9a-f]{32}", t)
                  for t in trace_ids), "obs: a sampled answer lacks its "
              "X-Oryx-Trace id")

        # the answers, against the same model's plain phase-A versions
        Q = np.stack([X[int(u[1:])] for u in users])
        excl = [set(known[u]) for u in users]
        want, _ = reference_top_n_batch(model, 10, Q, excl)
        for path, (_, body, _, _), w in zip(paths, sampled, want):
            got = [(d["id"], d["value"]) for d in json.loads(body)]
            check(len(got) == 10 and all(np.isfinite(v) for _, v in got),
                  f"obs: {path} gave {got}")
            same_answers(got, w, RTOL["float32"], f"obs {path}")

        # /metrics: JSON, Prometheus, OpenMetrics
        route = "GET /recommend/{userID}"
        metrics = json.loads(http_call(port, "GET", "/metrics")[1])
        count = metrics["routes"][route]["count"]
        check(count == 3 * OBS_REQUESTS,
              f"obs: /metrics counts {count} of {3 * OBS_REQUESTS} requests")
        by_route = metrics["device_time"]["by_route"]
        serve = [r for r in by_route if r["route_class"] == "serve"
                 and r["kernel_route"] == _label(route_label)]
        check(serve, f"obs: no serve entry for {route_label}: {by_route}")
        check(any(r["route_class"] == "measure" for r in by_route),
              f"obs: no measure entry: {by_route}")
        busy = metrics["freshness"]["device_busy_fraction"]
        check(0.0 < busy <= 1.0, f"obs: device_busy_fraction {busy}")
        prom = http_call(port, "GET", "/metrics?format=prometheus")[1]\
            .decode()
        counter = f"oryx_device_time_us_serve_{_label(route_label)}_total"
        check(counter in prom, f"obs: {counter} not in the exposition")
        om = http_call(port, "GET", "/metrics?format=openmetrics")[1]\
            .decode()
        check(om.endswith("# EOF\n"), "obs: OpenMetrics lacks # EOF")
        exemplars = set(re.findall(r'# \{trace_id="([0-9a-f]{32})"\}', om))
        traces = json.loads(http_call(
            port, "GET", f"/admin/traces?limit={4 * OBS_REQUESTS}")[1])[
                "traces"]
        check(exemplars and exemplars <= set(traces),
              f"obs: exemplars {sorted(exemplars - set(traces))} are not "
              f"on /admin/traces")

        # /admin/traces: each sampled request's tree
        batches, sums_off = [], 0.0
        for tid in trace_ids:
            spans = traces.get(tid)
            check(spans is not None, f"obs: trace {tid} not on the ring")
            by_name = {s["name"]: s for s in spans}
            check(set(by_name) == {"serving.request", "serving.queue_wait",
                                   "serving.device_execute"},
                  f"obs: trace {tid} has spans {sorted(by_name)}")
            root = by_name["serving.request"]
            ex = by_name["serving.device_execute"]
            check(ex["parent_id"] == root["span_id"] ==
                  by_name["serving.queue_wait"]["parent_id"],
                  f"obs: trace {tid} parentage")
            check(ex["attrs"].get("kernel_route") == route_label
                  and ex["attrs"].get("batch_size", 0) >= 1,
                  f"obs: trace {tid} execute attrs {ex['attrs']}")
            batches.append(ex["attrs"]["batch_size"])
            stages = anatomy.analyze_trace(spans)
            sums_off = max(sums_off, abs(sum(stages["stages"].values())
                                         - stages["total_ms"]))
        check(sums_off <= 0.0005 * (len(anatomy.STAGES) + 1),
              f"obs: stages miss their root by {sums_off} ms")
        tail = json.loads(http_call(
            port, "GET", f"/admin/tail?limit={4 * OBS_REQUESTS}&k=5")[1])
        for entry in tail["top"]:
            check(abs(sum(entry["stages"].values()) - entry["total_ms"])
                  <= 0.0005 * (len(anatomy.STAGES) + 1),
                  f"obs: /admin/tail stages miss {entry['trace_id']}")
        mean_total = sum(v["mean_ms"] for v in tail["stages"].values())
        stage_share = {k: v["mean_ms"] / mean_total
                       for k, v in tail["stages"].items() if v["mean_ms"]}

        # /admin/profile over a second burst; a second capture meanwhile
        # gets 503
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            traffic = pool.submit(burst, 1.0)
            time.sleep(0.05)
            capture = pool.submit(http_call, port, "GET",
                                  f"/admin/profile?ms={OBS_PROFILE_MS}")
            time.sleep(0.15)
            second = http_call(port, "GET", "/admin/profile?ms=10")
            traffic.result()
            status, body, _ = capture.result()
        check(status == 200, f"obs: /admin/profile gave {status}: "
              f"{body[:300]}")
        check(second[0] == 503, f"obs: a concurrent capture gave "
              f"{second[0]}, not 503")
        profile = json.loads(body)
        check(profile["activities"] == ["CPU", "CUDA"],
              f"obs: the capture recorded {profile['activities']}")
        busy_after = json.loads(http_call(port, "GET", "/metrics")[1])[
            "freshness"]["device_busy_fraction"]
        seen = profile_kernels(profile["trace_file"],
                               kernel_symbols(expected),
                               profile["captured_ms"])
        check(seen["routed_events"] > 0,
              f"obs: the capture holds no event of {expected}'s kernels "
              f"({seen['kernel_events']} kernel events)")
        log({"phase": "profile", "config": label, "kernel": expected,
             "requested_ms": profile["requested_ms"],
             "captured_ms": profile["captured_ms"], **seen,
             "device_busy_fraction": busy_after,
             "trace_bytes": os.path.getsize(profile["trace_file"]),
             "second_capture_status": second[0]})

        # the wide-event log: one line per sampled request
        events_dir = cfg.get_string("oryx.obs.events.dir")
        lines = []
        for name in os.listdir(events_dir):
            with open(os.path.join(events_dir, name), encoding="utf-8") as f:
                lines += [json.loads(x) for x in f]
        rec = [e for e in lines if e["route"] == route and e["sampled"]]
        check(len(rec) == 3 * OBS_REQUESTS,
              f"obs: {len(rec)} event lines for {3 * OBS_REQUESTS} "
              f"sampled requests")
        check(all(e.get("kernel_route") == route_label
                  and e.get("batch_size", 0) >= 1 and "queue_wait_ms" in e
                  for e in rec), "obs: an event line lacks its batch fields")

        # the flight recorder, /admin/diagnose, /admin/slo
        status, body, _ = http_call(port, "POST", "/admin/flight/dump")
        dump = json.loads(body)
        check(status == 200 and dump["dumped"], f"obs: dump gave {dump}")
        with open(dump["path"], encoding="utf-8") as f:
            bundle = json.load(f)
        check(bundle["device_time"]["by_route"]
              and bundle["device_memory"][0]["memory_stats"][
                  "bytes_in_use"] > 0,
              "obs: the bundle lacks the device time or the card's memory")
        for path in ("/admin/diagnose", "/admin/slo"):
            status = http_call(port, "GET", path)[0]
            check(status == 200, f"obs: {path} gave {status}")
        diagnosis = json.loads(http_call(port, "GET",
                                         "/admin/diagnose")[1])
    finally:
        layer.close()
    check(not layer.consuming, "obs: the consumer outlived close()")

    # the cost of observability: the rounds against phase 4's, and the
    # hot-path microbench in this process
    over = obs_overhead.run_bench(iterations=OBS_OVERHEAD_ITERATIONS)
    micro = over["microbench_ns_per_request"]
    line = {"phase": "obs", "config": label, "kind": kind,
            "route": route_label, "load_s": load_s,
            "load_overlapped": "deploy",
            "ready_waited_s": ready_waited_s,
            "start_s": started["start_s"], "requests": OBS_REQUESTS, "concurrency": OBS_CLIENTS,
            "launches": launches,
            "sampled": percentiles(r[2] for r in sampled),
            "unsampled": percentiles(r[2] for r in unsampled),
            "phase4": ({k: topic[k] for k in ("p50_ms", "p99_ms",
                                              "requests")}
                       if topic else None),
            "mean_batch": float(np.mean(batches)),
            "device_busy_fraction": busy,
            "device_time": metrics["device_time"],
            "tail_stage_share": tail["tail"]["stage_share"],
            "mean_stage_share": stage_share,
            "event_lines": len(rec), "flight_dumps": 1,
            "diagnosis": [c["cause"] for c in diagnosis["causes"]],
            "overhead_ns": micro, "overhead_budget_us": OBS_BUDGET_US,
            "overhead_worst_unsampled_us":
                micro["unsampled_recorder_armed"] / 1e3,
            "seconds": time.perf_counter() - t_phase}
    log(line)
    return line


# -- phase 11: the serving cluster on one card --------------------------------

def cluster_data(seed: int):
    """(Y, X, known items) of the cluster's model."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((CLUSTER_ITEMS, CLUSTER_FEATURES),
                            dtype=np.float32)
    X = rng.standard_normal((CLUSTER_USERS, CLUSTER_FEATURES),
                            dtype=np.float32)
    known = {f"u{u}": sorted({f"i{j}" for j in rng.integers(
        0, CLUSTER_ITEMS, KNOWN_PER_USER)}) for u in range(CLUSTER_USERS)}
    return Y, X, known


def publish_cluster_model(model_dir: str, seed: int) -> None:
    """Write the cluster's model directory (the PMML document, the
    sliced factors and the users with their known items).  Runs in a
    child process while the card works on the earlier phases; touches
    no card."""
    from oryx_tpu_torch.app.als import slices
    from oryx_tpu_torch.common import pmml as pmml_io
    # below the timed phases' host work: it has until phase 11
    os.nice(10)
    t0 = time.perf_counter()
    Y, X, known = cluster_data(seed)
    y_ids = [f"i{j}" for j in range(CLUSTER_ITEMS)]
    x_ids = [f"u{u}" for u in range(CLUSTER_USERS)]
    doc = pmml_io.build_skeleton_pmml()
    pmml_io.add_extension(doc, "features", CLUSTER_FEATURES)
    pmml_io.add_extension(doc, "implicit", True)
    pmml_io.add_extension_content(doc, "XIDs", x_ids)
    pmml_io.add_extension_content(doc, "YIDs", y_ids)
    pmml_io.write(doc, os.path.join(model_dir, "model.pmml.xml"))
    slim = slices.publish_sliced(model_dir, y_ids, Y, x_ids, X, known,
                                 CLUSTER_RING)
    with open(os.path.join(model_dir, "published.json"), "w",
              encoding="utf-8") as f:
        json.dump({"manifest": slim,
                   "seconds": time.perf_counter() - t0}, f)


def cluster_overlay(work_dir: str, password: str, shard: int | None) -> dict:
    """The keys phase 11 sets over the port's example config: a
    ``file://`` broker of its own, DIGEST credentials on every door, and
    for a replica its shard of two."""
    broker = "file://" + os.path.join(work_dir, "cluster", "broker")
    overlay = {"oryx.update-topic.broker": broker,
               "oryx.input-topic.broker": broker,
               "oryx.serving.api.user-name": CLUSTER_USER,
               "oryx.serving.api.password": password,
               "oryx.cluster.heartbeat-interval-ms": 200}
    if shard is not None:
        overlay.update({"oryx.cluster.enabled": True,
                        "oryx.cluster.shard": f"{shard}/2",
                        "oryx.cluster.replica-id": f"replica-{shard}"})
    return overlay


def cluster_config(overlay: dict):
    from oryx_tpu_torch.common.config import from_file, overlay_on
    return overlay_on(overlay, from_file(os.path.join(
        REPO, "oryx_tpu_torch", "conf", "als-example.conf")))


def replica_state(layer) -> dict:
    """What the parent reads of a replica: its load, its route and its
    kernels' launch counts."""
    mgr = layer.model_manager
    model = mgr.get_model()
    out = {"launches": read_launches(), "loaded": False,
           "tport": layer._frame_server.port
           if layer._frame_server is not None else None}
    if model is not None:
        route = model._route_current(len(model.Y.row_ids())) \
            if model._route is not None else None
        out.update(loaded=model.get_fraction_loaded() >= 1.0
                   and route is not None,
                   items=len(model.Y), users=len(model.X),
                   slice_loads=mgr.slice_loads,
                   slice_load_fallbacks=mgr.slice_load_fallbacks,
                   model_load_s=mgr.model_load_s,
                   twophase_fallbacks=model.twophase_fallbacks,
                   kind=routed_kind(model) if route is not None else None,
                   route=model.kernel_route_label,
                   route_errors=(route or {}).get("errors"),
                   yty_from_manifest=mgr.partial_yty() is not None)
    return out


def cluster_replica(conn, overlay: dict, device: str) -> None:
    """One replica of phases 11-12, a ServingLayer in a process of its
    own: it sends its port, then answers the parent's commands —
    ``reset`` sets its kernels' launch counts to 0, ``state`` sends
    ``replica_state``, ``("vector", user)`` the user's vector,
    ``shard_cache`` the shard cache's stats, ``("tls_door", pem)`` opens
    a second door on the layer's HttpApp with TLS and sends its port,
    ``stop`` closes the layer."""
    import torch
    from oryx_tpu_torch.common import compile_cache
    from oryx_tpu_torch.common.config import from_dict
    from oryx_tpu_torch.lambda_rt.serving import ServingLayer
    from oryx_tpu_torch.ops import cuda_build
    # the libraries phase 1 built, in build/kernels
    compile_cache.enable_from_config(from_dict(
        {"oryx.compile-cache-dir": str(cuda_build.BUILD_DIR.parent)}))
    layer = ServingLayer(cluster_config(overlay), port=0, device=device)
    doors = []
    try:
        layer.start()
        conn.send(layer.port)
        while True:
            cmd = conn.recv()
            if cmd == "stop":
                break
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            if cmd == "reset":
                reset_launches()
                conn.send(None)
            elif cmd == "shard_cache":
                conn.send(layer._shard_cache.stats())
            elif isinstance(cmd, tuple) and cmd[0] == "vector":
                v = layer.model_manager.get_model().get_user_vector(cmd[1])
                conn.send(None if v is None else np.asarray(v, np.float32))
            elif isinstance(cmd, tuple) and cmd[0] == "tls_door":
                import ssl
                from oryx_tpu_torch.lambda_rt.http import make_server
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.load_cert_chain(cmd[1])
                door = make_server(layer.app, 0, ssl_context=ctx)
                threading.Thread(target=door.serve_forever,
                                 daemon=True).start()
                doors.append(door)
                conn.send(door.server_address[1])
            else:
                conn.send(replica_state(layer))
    finally:
        for door in doors:
            door.shutdown()
            door.server_close()
        layer.close()


class DigestClient:
    """The phase's HTTP client: the serving tier's DIGEST scheme (MD5,
    ``qop="auth"``), one challenge, then the cached nonce with a counter;
    a request answered 401 is challenged again."""

    def __init__(self, user: str, password: str):
        self.user, self.password = user, password
        self._lock = threading.Lock()
        self._state = None  # (realm, nonce, next nc)

    def _header(self, method: str, path: str) -> str | None:
        import hashlib
        import secrets
        with self._lock:
            if self._state is None:
                return None
            realm, nonce, nc = self._state
            self._state = (realm, nonce, nc + 1)

        def md5(text: str) -> str:
            return hashlib.md5(text.encode()).hexdigest()

        cnonce, ncs = secrets.token_hex(8), f"{nc:08x}"
        ha1 = md5(f"{self.user}:{realm}:{self.password}")
        ha2 = md5(f"{method}:{path}")
        response = md5(f"{ha1}:{nonce}:{ncs}:{cnonce}:auth:{ha2}")
        return (f'Digest username="{self.user}", realm="{realm}", '
                f'nonce="{nonce}", uri="{path}", qop=auth, nc={ncs}, '
                f'cnonce="{cnonce}", response="{response}"')

    def call(self, port: int, method: str, path: str,
             body: bytes | None = None):
        """(status, body, milliseconds) of one authenticated request."""
        return self.call_full(port, method, path, body)[:3]

    def call_full(self, port: int, method: str, path: str,
                  body: bytes | None = None):
        """(status, body, milliseconds, lower-cased response headers) of
        one authenticated request."""
        for _ in range(3):
            header = self._header(method, path)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            try:
                t0 = time.perf_counter()
                conn.request(method, path, body=body, headers={
                    "Accept": "application/json",
                    **({"Authorization": header} if header else {})})
                resp = conn.getresponse()
                out = resp.read()
                ms = (time.perf_counter() - t0) * 1e3
                challenge = resp.getheader("WWW-Authenticate", "")
            finally:
                conn.close()
            if resp.status != 401:
                return resp.status, out, ms, {
                    k.lower(): v for k, v in resp.getheaders()}
            pairs = dict((k, q or b) for k, q, b in re.findall(
                r'(\w+)=(?:"([^"]*)"|([^, ]*))', challenge))
            check("nonce" in pairs, f"cluster: a 401 without a challenge "
                  f"from port {port}")
            with self._lock:
                self._state = (pairs.get("realm", ""), pairs["nonce"], 1)
        raise RuntimeError(f"check failed: cluster: port {port} refused "
                           f"the credentials for {path}")


def start_replicas(overlays: list) -> tuple[list, list]:
    """One ``cluster_replica`` process per overlay: (pipes, processes)."""
    spawn = multiprocessing.get_context("spawn")
    pipes, procs = [], []
    for overlay in overlays:
        parent, child = spawn.Pipe()
        proc = spawn.Process(target=cluster_replica, daemon=True,
                             args=(child, overlay, DEVICE))
        proc.start()
        pipes.append(parent)
        procs.append(proc)
    return pipes, procs


def replica_ports(pipes, procs, what: str) -> list[int]:
    ports = []
    for shard, conn in enumerate(pipes):
        check(conn.poll(300), f"{what}: replica {shard} did not start")
        try:
            ports.append(conn.recv())
        except EOFError:
            raise RuntimeError(f"check failed: {what}: replica {shard} "
                               f"exited {procs[shard].exitcode} at "
                               f"start") from None
    return ports


def stop_replicas(pipes, procs) -> None:
    for conn in pipes:
        try:
            conn.send("stop")
        except OSError:
            pass
    for proc in procs:
        proc.join(60)
        if proc.is_alive():
            proc.terminate()
            proc.join(30)


def replica_state_of(conn, cmd="state"):
    conn.send(cmd)
    return conn.recv()


def cluster_oracle() -> tuple:
    """(model, X, known, Gramian) of the whole catalog in this process,
    as the replicas hold it (the slices' 8-decimal rounding)."""
    Y, X, known = cluster_data(CLUSTER_SEED)
    Y = np.round(Y.astype(np.float64), 8).astype(np.float32)
    X = np.round(X.astype(np.float64), 8).astype(np.float32)
    full = build_model(CLUSTER_FEATURES, Y, X, known, "float32")
    del Y
    return full, X, known, gramian64(full)


def send_model_ref(cfg, model_dir: str, manifest) -> None:
    from oryx_tpu_torch.app.als import slices
    from oryx_tpu_torch.kafka.inproc import InProcTopicProducer
    producer = InProcTopicProducer(
        cfg.get_string("oryx.update-topic.broker"),
        cfg.get_string("oryx.update-topic.message.topic"))
    producer.send("MODEL-REF", slices.model_ref_message(
        os.path.join(model_dir, "model.pmml.xml"), model_dir, manifest))
    producer.close()


def check_replica_launches(st: dict, shard: int, what: str) -> str:
    """The wrapper of the replica's routed kind, which must have
    launched, and no other."""
    expected = next(k for k, v in KERNELS.items() if v[2] == st["kind"])
    launches = st["launches"]
    check(launches[expected] > 0,
          f"{what}: replica {shard}'s {expected} launched no time: "
          f"{launches}")
    check(all(v == 0 for k, v in launches.items() if k != expected),
          f"{what}: replica {shard} launched another kernel than "
          f"{expected}: {launches}")
    return expected


def cluster_phase(publisher, work_dir: str, fast: dict | None = None,
                  region: dict | None = None) -> dict:
    """Phase 11: two serving-cluster replicas (shards 0/2 and 1/2, each
    a ServingLayer in a process of its own on the one card) load their
    halves of a 1,179,648 x 50 float32 model off a ``file://`` update
    topic; the router (this process) merges them behind DIGEST auth on
    every door.  Its answers against the single-node exact scan and a
    float64 fold-in, the replicas' routed kernels, /metrics and the
    write path.  With ``fast`` (phase 12's replicas, started beside
    these), the same MODEL-REF goes to phase 12's topic too; with
    ``region`` (phase 13's region B), the A -> B mirror starts when it
    is on this phase's topic."""
    import secrets
    from oryx_tpu_torch.cluster.router import RouterLayer
    from oryx_tpu_torch.kafka.inproc import resolve_broker

    t_phase = time.perf_counter()
    password = secrets.token_hex(12)
    pipes, procs = start_replicas(
        [cluster_overlay(work_dir, password, shard) for shard in (0, 1)])
    router = None
    try:
        router_cfg = cluster_config(cluster_overlay(work_dir, password,
                                                    None))
        router = RouterLayer(router_cfg, port=0, device=DEVICE)
        router.start()
        client = DigestClient(CLUSTER_USER, password)
        ports = replica_ports(pipes, procs, "cluster")
        state = replica_state_of
        oracle = cluster_oracle()
        full, X, known, gram = oracle
        t_wait = time.perf_counter()
        publisher.join(CLUSTER_WAIT_S)
        check(publisher.exitcode == 0,
              f"cluster: publishing the model failed ({publisher.exitcode})")
        model_dir = os.path.join(work_dir, "cluster_model")
        with open(os.path.join(model_dir, "published.json"),
                  encoding="utf-8") as f:
            published = json.load(f)
        waited_s = time.perf_counter() - t_wait
        if fast is not None:
            # phase 12's replicas load first, at least FAST_LEAD_S ahead,
            # so that their route measurements never overlap these
            # replicas'
            if fast["sent_at"] is None:
                send_model_ref(fast["config"], model_dir,
                               published["manifest"])
                fast["sent_at"] = time.perf_counter()
            time.sleep(max(0.0, FAST_LEAD_S
                           - (time.perf_counter() - fast["sent_at"])))
        t0 = time.perf_counter()
        send_model_ref(router_cfg, model_dir, published["manifest"])
        if region is not None:
            region_start(region, oracle)
        wait_for(lambda: client.call(router.port, "GET", "/ready")[0]
                 in (200, 204), "cluster: the router's /ready",
                 CLUSTER_WAIT_S)
        ready_s = time.perf_counter() - t0
        wait_for(lambda: all(state(c)["loaded"] for c in pipes),
                 "cluster: the replicas' loads and routes", CLUSTER_WAIT_S)
        loaded_s = time.perf_counter() - t0
        if fast is not None:
            # phase 12's replicas load beside these; their route
            # measurement must not overlap this phase's timed rounds
            fast_ports(fast)
            wait_for(lambda: all(state(c)["loaded"] for c in fast["pipes"]),
                     "cluster: phase 12's replicas' loads and routes",
                     CLUSTER_WAIT_S)
        states = [state(c) for c in pipes]
        for shard, st in enumerate(states):
            check(st["kind"] in KERNEL_KINDS and not st["route_errors"],
                  f"cluster: replica {shard} routes {st['kind']!r} "
                  f"({st['route_errors']})")
            check(st["slice_loads"] == CLUSTER_RING // 2
                  and st["slice_load_fallbacks"] == 0
                  and st["users"] == CLUSTER_USERS
                  and st["yty_from_manifest"],
                  f"cluster: replica {shard} loaded {st}")
        check(sum(st["items"] for st in states) == CLUSTER_ITEMS,
              f"cluster: the shards hold {[st['items'] for st in states]} "
              f"of {CLUSTER_ITEMS} items")

        rng = np.random.default_rng(CLUSTER_SEED + 1)
        users = [f"u{u}" for u in rng.choice(CLUSTER_USERS,
                                             CLUSTER_REQUESTS,
                                             replace=False)]
        paths = [f"/recommend/{u}?howMany=10" for u in users]
        ctxs = contexts(rng, CLUSTER_ITEMS, CLUSTER_ANONYMOUS)
        anon_paths = round_paths(ctxs, [None] * len(ctxs))

        def burst(port: int, todo: list) -> list:
            with concurrent.futures.ThreadPoolExecutor(
                    CLUSTER_CLIENTS) as pool:
                out = list(pool.map(
                    lambda p: client.call(port, "GET", p), todo))
            for path, (status, body, _) in zip(todo, out):
                check(status == 200,
                      f"cluster: {path} gave {status}: {body[:300]}")
            return out

        burst(router.port, paths[:64])  # untimed: the batchers learn
        for conn in pipes:
            conn.send("reset")
            conn.recv()
        routed = burst(router.port, paths)
        anonymous = burst(router.port, anon_paths)
        states = [state(c) for c in pipes]
        replicas = []
        for shard, st in enumerate(states):
            expected = check_replica_launches(st, shard, "cluster")
            replicas.append({"shard": f"{shard}/2", "kind": st["kind"],
                             "route": st["route"], "kernel": expected,
                             "launches": st["launches"],
                             "items": st["items"],
                             "model_load_s": st["model_load_s"],
                             "twophase_fallbacks":
                                 st["twophase_fallbacks"]})
            log({"phase": "cluster_replica", **replicas[-1]})

        # /recommend: the single-node exact top-N over the whole catalog
        Q = np.stack([X[int(u[1:])] for u in users])
        want = exact_top_n(full, 10, Q, [set(known[u]) for u in users])
        for path, (_, body, _), w in zip(paths, routed, want):
            got = [(d["id"], d["value"]) for d in json.loads(body)]
            check(len(got) == 10, f"cluster: {path} gave {got}")
            same_answers(got, w, RTOL["float32"], f"cluster {path}")
        # /recommendToAnonymous: a float64 fold-in over the summed
        # Gramian, then the exact top-N of its vector
        Qa = []
        for ctx in ctxs:
            x = fold_in_f64(gram, full, ctx, None)
            check(x is not None, f"cluster: {ctx} folded into nothing")
            Qa.append(x.astype(np.float32))
        want = exact_top_n(full, 10, np.stack(Qa),
                           [{i for i, _ in c} for c in ctxs])
        for path, (_, body, _), w in zip(anon_paths, anonymous, want):
            got = [(d["id"], d["value"]) for d in json.loads(body)]
            check(len(got) == 10, f"cluster: {path} gave {got}")
            check([i for i, _ in got] == [i for i, _ in w],
                  f"cluster {path}: ids {got} != {w}")
            np.testing.assert_allclose(
                [v for _, v in got], [v for _, v in w], rtol=FOLD_RTOL,
                atol=FOLD_ATOL, err_msg=f"cluster {path}")

        # one /pref through the router onto the input topic
        in_topic = router_cfg.get_string("oryx.input-topic.message.topic")
        broker = resolve_broker(router_cfg.get_string(
            "oryx.input-topic.broker"))
        before = sum(broker.latest_offsets(in_topic))
        status = client.call(router.port, "POST", f"/pref/{users[0]}/i7",
                             b"2.5")[0]
        check(status in (200, 204), f"cluster: /pref gave {status}")
        check(sum(broker.latest_offsets(in_topic)) == before + 1,
              "cluster: /pref appended no record to the input topic")

        # /metrics: both shards live; no partial answer, no shard failure
        metrics = json.loads(client.call(router.port, "GET",
                                         "/metrics")[1])
        cl = metrics["cluster"]
        live = sorted(r["shard"] for r in
                      cl["membership"]["replicas"].values()
                      if r["live"] and r["ready"])
        check(cl["covered_shards"] == [0, 1] and live == [0, 1]
              and cl["membership"]["shards"] == 2,
              f"cluster: /metrics shows {cl['membership']}")
        check(metrics["counters"].get("partial_answers", 0) == 0
              and cl["scatter"]["shard_failures"] == 0,
              f"cluster: partial answers or shard failures: "
              f"{metrics['counters']} {cl['scatter']}")
        # the fold-in route one request at a time: its cost without the
        # 32 clients' queueing
        serial = [client.call(router.port, "GET", p)
                  for p in anon_paths[:CLUSTER_SERIAL]]
        check(all(r[0] == 200 for r in serial),
              "cluster: a serial /recommendToAnonymous failed")
        # one replica's own /recommend (its shard alone), for its latency
        own = burst(ports[0], paths)
    finally:
        if router is not None:
            router.close()
        stop_replicas(pipes, procs)
    check(all(p.exitcode == 0 for p in procs),
          f"cluster: a replica exited {[p.exitcode for p in procs]}")
    line = {"phase": "cluster", "items": CLUSTER_ITEMS,
            "features": CLUSTER_FEATURES, "users": CLUSTER_USERS,
            "replicas": replicas, "concurrency": CLUSTER_CLIENTS,
            "publish_s": published["seconds"], "publish_waited_s": waited_s,
            "router_ready_s": ready_s, "replicas_loaded_s": loaded_s,
            "router": {"requests": len(routed),
                       **percentiles(r[2] for r in routed)},
            "router_anonymous": {"requests": len(anonymous),
                                 **percentiles(r[2] for r in anonymous)},
            "router_anonymous_serial": {
                "requests": len(serial),
                **percentiles(r[2] for r in serial)},
            "replica0_own": {"requests": len(own),
                             **percentiles(r[2] for r in own)},
            "scatter": cl["scatter"],
            "seconds": time.perf_counter() - t_phase}
    log(line)
    # phase 12 reuses the oracle (not printed)
    return {**line, "oracle": oracle}


# -- phase 12: the serving cluster's fast path on one card ---------------------

def fast_overlay(work_dir: str, password: str, shard: int | None) -> dict:
    """Phase 11's keys over a broker of phase 12's own, with the framed
    transport on both ends, the shard cache on each replica, and the
    asyncio front end, result cache and coalescing on the router."""
    overlay = cluster_overlay(work_dir, password, shard)
    broker = "file://" + os.path.join(work_dir, "cluster_fast", "broker")
    overlay.update({"oryx.update-topic.broker": broker,
                    "oryx.input-topic.broker": broker,
                    "oryx.cluster.transport.enabled": True})
    if shard is None:
        overlay.update({"oryx.cluster.async.enabled": True,
                        "oryx.cluster.cache.enabled": True,
                        "oryx.cluster.coalesce.enabled": True})
    else:
        overlay["oryx.cluster.replica-cache.enabled"] = True
    return overlay


def start_fast_replicas(work_dir: str) -> dict:
    """Phase 12's two replicas, started before phase 11 so that their
    start and load overlap its work; phase 11 sends them the MODEL-REF,
    ``FAST_LEAD_S`` ahead of its own."""
    import secrets
    password = secrets.token_hex(12)
    pipes, procs = start_replicas(
        [fast_overlay(work_dir, password, shard) for shard in (0, 1)])
    return {"pipes": pipes, "procs": procs, "password": password,
            "config": cluster_config(fast_overlay(work_dir, password,
                                                  None)),
            "ports": None, "sent_at": None}


def send_fast_model_ref(fast: dict, publisher, work_dir: str) -> None:
    """Phase 12's MODEL-REF, sent once the model is published."""
    publisher.join(CLUSTER_WAIT_S)
    check(publisher.exitcode == 0,
          f"cluster_fast: publishing the model failed ({publisher.exitcode})")
    model_dir = os.path.join(work_dir, "cluster_model")
    with open(os.path.join(model_dir, "published.json"),
              encoding="utf-8") as f:
        manifest = json.load(f)["manifest"]
    send_model_ref(fast["config"], model_dir, manifest)
    fast["sent_at"] = time.perf_counter()


def fast_ports(fast: dict) -> list[int]:
    """Phase 12's replica ports, read off their pipes once."""
    if fast["ports"] is None:
        fast["ports"] = replica_ports(fast["pipes"], fast["procs"],
                                      "cluster_fast")
    return fast["ports"]


def self_signed_pem(directory: str) -> str:
    """A throwaway certificate and key for a TLS door on 127.0.0.1."""
    pem = os.path.join(directory, "door.pem")
    try:
        import datetime
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID
    except ImportError:
        key, cert = pem + ".key", pem + ".crt"
        subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                        "-nodes", "-keyout", key, "-out", cert, "-days",
                        "1", "-subj", "/CN=localhost"], check=True,
                       capture_output=True, timeout=60)
        with open(pem, "wb") as out:
            for part in (key, cert):
                with open(part, "rb") as f:
                    out.write(f.read())
        return pem
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=1))
            .not_valid_after(now + datetime.timedelta(days=1))
            .sign(key, hashes.SHA256()))
    with open(pem, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption())
            + cert.public_bytes(serialization.Encoding.PEM))
    return pem


def h2_get(port: int, paths: list, digest: "DigestClient",
           tls: bool) -> list:
    """GET each path on one HTTP/2 connection (h2c with prior
    knowledge, or TLS with ALPN ``h2``), one stream each, all sent
    before any answer is read, with DIGEST headers from ``digest``'s
    nonce: [(status, body)] in path order.  A raw-socket client on the
    port's own HPACK codec."""
    import ssl
    from oryx_tpu_torch.lambda_rt.hpack import HpackDecoder, HpackEncoder
    from oryx_tpu_torch.lambda_rt.http2 import PREFACE
    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    if tls:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        ctx.set_alpn_protocols(["h2"])
        sock = ctx.wrap_socket(sock)
        check(sock.selected_alpn_protocol() == "h2",
              f"cluster_fast: ALPN chose {sock.selected_alpn_protocol()}")

    def frame(ftype: int, flags: int, sid: int, payload: bytes) -> bytes:
        return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
                + sid.to_bytes(4, "big") + payload)

    enc, dec = HpackEncoder(), HpackDecoder()
    out = {}
    try:
        sock.sendall(PREFACE + frame(4, 0, 0, b""))
        for n, path in enumerate(paths):
            headers = [(":method", "GET"), (":path", path),
                       (":scheme", "https" if tls else "http"),
                       (":authority", f"127.0.0.1:{port}"),
                       ("accept", "application/json")]
            auth = digest._header("GET", path)
            if auth:
                headers.append(("authorization", auth))
            sock.sendall(frame(1, 0x5, 2 * n + 1, enc.encode(headers)))
        r = sock.makefile("rb")
        while len([v for v in out.values() if v.get("done")]) < len(paths):
            head = r.read(9)
            check(len(head) == 9, "cluster_fast: the h2 connection closed")
            length = int.from_bytes(head[:3], "big")
            ftype, flags = head[3], head[4]
            sid = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
            payload = r.read(length)
            if ftype == 1:  # HEADERS
                st = out.setdefault(sid, {"body": b""})
                st["status"] = int(dict(dec.decode(payload))[":status"])
                st["done"] = bool(flags & 0x1)
            elif ftype == 0:  # DATA
                st = out[sid]
                st["body"] += payload
                st["done"] = bool(flags & 0x1)
                if payload:
                    sock.sendall(frame(8, 0, 0, len(payload).to_bytes(
                        4, "big")))
            elif ftype == 4 and not flags & 0x1:  # SETTINGS: ack it
                sock.sendall(frame(4, 0x1, 0, b""))
            elif ftype == 7:  # GOAWAY
                raise RuntimeError(f"check failed: cluster_fast: GOAWAY "
                                   f"{payload!r}")
    finally:
        sock.close()
    return [(out[2 * n + 1]["status"], out[2 * n + 1]["body"])
            for n in range(len(paths))]


def cluster_fast_phase(publisher, work_dir: str, fast: dict,
                       phase11: dict | None) -> dict:
    """Phase 12: phase 11's model behind the cluster's fast path — two
    replicas with the framed transport and the shard cache, and the
    router (this process) on the asyncio front end with the result cache
    and coalescing, DIGEST on every door and on the AUTH frame.  Seven
    checks: exact answers through the fast path, every scatter by frame,
    byte-equal hits that touch no device, coalescing, invalidation
    after /pref, the replica cache, and HTTP/2."""
    from collections import Counter
    from oryx_tpu_torch.cluster.membership import Heartbeat
    from oryx_tpu_torch.cluster.router import RouterLayer
    from oryx_tpu_torch.cluster.transport import FrameTransport
    from oryx_tpu_torch.kafka.inproc import InProcTopicProducer, \
        resolve_broker
    from oryx_tpu_torch.resilience import faults

    t_phase = time.perf_counter()
    pipes, procs, password = fast["pipes"], fast["procs"], fast["password"]
    router = None
    try:
        router_cfg = fast["config"]
        router = RouterLayer(router_cfg, port=0, device=DEVICE)
        router.start()
        client = DigestClient(CLUSTER_USER, password)
        ports = fast_ports(fast)
        state = replica_state_of
        oracle = phase11["oracle"] if phase11 is not None \
            else cluster_oracle()
        full, X, known, gram = oracle
        t0 = time.perf_counter()
        if fast["sent_at"] is None:
            # phase 11 did not run: this phase waits for the publisher
            publisher.join(CLUSTER_WAIT_S)
            check(publisher.exitcode == 0, f"cluster_fast: publishing the "
                  f"model failed ({publisher.exitcode})")
            model_dir = os.path.join(work_dir, "cluster_model")
            with open(os.path.join(model_dir, "published.json"),
                      encoding="utf-8") as f:
                manifest = json.load(f)["manifest"]
            t0 = time.perf_counter()
            send_model_ref(router_cfg, model_dir, manifest)
            fast["sent_at"] = t0
        wait_for(lambda: client.call(router.port, "GET", "/ready")[0]
                 in (200, 204), "cluster_fast: the router's /ready",
                 CLUSTER_WAIT_S)
        wait_for(lambda: all(state(c)["loaded"] for c in pipes),
                 "cluster_fast: the replicas' loads and routes",
                 CLUSTER_WAIT_S)
        waited_s = time.perf_counter() - t0
        states = [state(c) for c in pipes]
        for shard, st in enumerate(states):
            check(st["kind"] in KERNEL_KINDS and not st["route_errors"]
                  and st["tport"],
                  f"cluster_fast: replica {shard} routes {st['kind']!r} "
                  f"({st['route_errors']}), transport port {st['tport']}")
            check(st["slice_loads"] == CLUSTER_RING // 2
                  and st["slice_load_fallbacks"] == 0
                  and st["users"] == CLUSTER_USERS,
                  f"cluster_fast: replica {shard} loaded {st}")

        # users phase 11 did not send (its draw, replayed), and its
        # /recommendToAnonymous contexts
        rng = np.random.default_rng(CLUSTER_SEED + 1)
        sent11 = rng.choice(CLUSTER_USERS, CLUSTER_REQUESTS, replace=False)
        ctxs = contexts(rng, CLUSTER_ITEMS, CLUSTER_ANONYMOUS)
        picks = np.random.default_rng(CLUSTER_SEED + 2).choice(
            np.setdiff1d(np.arange(CLUSTER_USERS), sent11),
            FAST_WARM + CLUSTER_REQUESTS + 1, replace=False)
        warm = [f"/recommend/u{u}?howMany=10" for u in picks[:FAST_WARM]]
        users = [f"u{u}" for u in picks[FAST_WARM:-1]]
        cold = f"/recommend/u{picks[-1]}?howMany=10"
        paths = [f"/recommend/{u}?howMany=10" for u in users]

        def burst(todo: list, clients: int = CLUSTER_CLIENTS) -> list:
            with concurrent.futures.ThreadPoolExecutor(clients) as pool:
                out = list(pool.map(
                    lambda p: client.call_full(router.port, "GET", p),
                    todo))
            for path, (status, body, _, _) in zip(todo, out):
                check(status == 200,
                      f"cluster_fast: {path} gave {status}: {body[:300]}")
            return out

        def verdicts(rounds: list) -> dict:
            return dict(Counter(r[3].get("x-oryx-cache") for r in rounds))

        burst(warm)  # untimed: the batchers learn
        for conn in pipes:
            state(conn, "reset")
        # 1. exact answers through the fast path, every one a miss
        t_miss = time.perf_counter()
        miss = burst(paths)
        miss_s = time.perf_counter() - t_miss
        check(verdicts(miss) == {"miss": len(paths)},
              f"cluster_fast: the first pass's verdicts {verdicts(miss)}")
        states = [state(c) for c in pipes]
        replicas = []
        for shard, st in enumerate(states):
            expected = check_replica_launches(st, shard, "cluster_fast")
            replicas.append({"shard": f"{shard}/2", "kind": st["kind"],
                             "kernel": expected, "launches": st["launches"],
                             "model_load_s": st["model_load_s"]})
            log({"phase": "cluster_fast_replica", **replicas[-1]})
        Q = np.stack([X[int(u[1:])] for u in users])
        want = exact_top_n(full, 10, Q, [set(known[u]) for u in users])
        for path, (_, body, _, _), w in zip(paths, miss, want):
            got = [(d["id"], d["value"]) for d in json.loads(body)]
            check(len(got) == 10, f"cluster_fast: {path} gave {got}")
            same_answers(got, w, RTOL["float32"], f"cluster_fast {path}")
        # 2. every scatter went by frame
        metrics = json.loads(client.call(router.port, "GET",
                                         "/metrics")[1])
        sc = metrics["cluster"]["scatter"]
        gauges = metrics.get("freshness", {})
        check(gauges.get("transport_open_connections") == 2
              and sc["transport"]["open_connections"] == 2,
              f"cluster_fast: transport connections {gauges} "
              f"{sc.get('transport')}")
        check(sc["pool"]["attempts"] == 0 and sc["pool"]["sockets"] == 0,
              f"cluster_fast: the HTTP/1.1 pool carried a shard query: "
              f"{sc['pool']}")
        check(sc["hedges"] == 0 and sc["shard_failures"] == 0
              and sc["partial_answers"] == 0
              and metrics["counters"].get("partial_answers", 0) == 0,
              f"cluster_fast: hedges, shard failures or partial answers: "
              f"{sc}")
        # 3. the same paths again: hits, byte-equal, no device work
        before = [state(c)["launches"] for c in pipes]
        t_hit = time.perf_counter()
        hit = burst(paths)
        hit_s = time.perf_counter() - t_hit
        check(verdicts(hit) == {"hit": len(paths)},
              f"cluster_fast: the second pass's verdicts {verdicts(hit)}")
        check(all(h[1] == m[1] for h, m in zip(hit, miss)),
              "cluster_fast: a hit's body differs from its miss's")
        after = [state(c)["launches"] for c in pipes]
        check(after == before,
              f"cluster_fast: hits launched kernels: {before} -> {after}")
        # the fold-in round of phase 11 through the asyncio front end
        anon_paths = round_paths(ctxs, [None] * len(ctxs))
        anonymous = burst(anon_paths)
        Qa = []
        for ctx in ctxs:
            x = fold_in_f64(gram, full, ctx, None)
            check(x is not None, f"cluster_fast: {ctx} folded into nothing")
            Qa.append(x.astype(np.float32))
        want = exact_top_n(full, 10, np.stack(Qa),
                           [{i for i, _ in c} for c in ctxs])
        for path, (_, body, _, _), w in zip(anon_paths, anonymous, want):
            got = [(d["id"], d["value"]) for d in json.loads(body)]
            check([i for i, _ in got] == [i for i, _ in w],
                  f"cluster_fast {path}: ids {got} != {w}")
            np.testing.assert_allclose(
                [v for _, v in got], [v for _, v in w], rtol=FOLD_RTOL,
                atol=FOLD_ATOL, err_msg=f"cluster_fast {path}")
        # 4. a wave of identical requests on a cold user: one scatter,
        # its leader held FAST_HOLD_S so that every follower arrives
        # while it is in flight
        faults.inject("router-shard-timeout", mode="delay", times=2,
                      delay_sec=FAST_HOLD_S)
        gate = threading.Barrier(FAST_BURST)

        def one(_):
            gate.wait()
            return client.call_full(router.port, "GET", cold)

        try:
            with concurrent.futures.ThreadPoolExecutor(FAST_BURST) as pool:
                wave = list(pool.map(one, range(FAST_BURST)))
            held = faults.fired("router-shard-timeout")
        finally:
            faults.clear("router-shard-timeout")
        check(all(r[0] == 200 for r in wave)
              and verdicts(wave) == {"miss": 1, "coalesced": FAST_BURST - 1}
              and len({r[1] for r in wave}) == 1 and held == 2,
              f"cluster_fast: the wave's verdicts {verdicts(wave)}, "
              f"{len({r[1] for r in wave})} bodies, {held} held scatters")
        # 5. /pref invalidates the user's entry: the speed layer's UP
        # (a float64 fold-in of the event) goes on the update topic
        u = users[0]
        xu = X[int(u[1:])]
        item = next(f"i{j}" for j in np.random.default_rng(
            CLUSTER_SEED + 3).integers(0, CLUSTER_ITEMS, 64)
            if f"i{j}" not in known[u])
        in_topic = router_cfg.get_string("oryx.input-topic.message.topic")
        broker = resolve_broker(router_cfg.get_string(
            "oryx.input-topic.broker"))
        n_in = sum(broker.latest_offsets(in_topic))
        status = client.call(router.port, "POST", f"/pref/{u}/{item}",
                             b"2.5")[0]
        check(status in (200, 204), f"cluster_fast: /pref gave {status}")
        check(sum(broker.latest_offsets(in_topic)) == n_in + 1,
              "cluster_fast: /pref appended no record to the input topic")
        x_new = fold_in_f64(gram, full, [(item, 2.5)], xu).astype(
            np.float32)
        evicted = router.result_cache.stats()["invalidations"]
        producer = InProcTopicProducer(
            router_cfg.get_string("oryx.update-topic.broker"),
            router_cfg.get_string("oryx.update-topic.message.topic"))
        producer.send("UP", json.dumps(
            ["X", u, [float(v) for v in x_new], [item]]))
        producer.close()
        wait_for(lambda: router.result_cache.stats()["invalidations"]
                 > evicted, "cluster_fast: the router's eviction", 60)
        wait_for(lambda: all(np.array_equal(state(c, ("vector", u)), x_new)
                             for c in pipes),
                 "cluster_fast: the replicas' UP", 60)
        status, body, _, headers = client.call_full(router.port, "GET",
                                                    paths[0])
        check(status == 200 and headers.get("x-oryx-cache") == "miss",
              f"cluster_fast: after /pref {paths[0]} gave {status} "
              f"{headers.get('x-oryx-cache')} (a stale hit)")
        got = [(d["id"], d["value"]) for d in json.loads(body)]
        w = exact_top_n(full, 10, x_new[None], [set(known[u]) | {item}])[0]
        same_answers(got, w, RTOL["float32"], f"cluster_fast {paths[0]} "
                     f"after /pref")
        # 6. the replica cache: a shard query repeated on the framed hop
        # under the same epoch is a hit and launches nothing
        hb = Heartbeat(replica="replica-0", shard=0, of=2,
                       url=f"http://127.0.0.1:{ports[0]}", generation=1,
                       ready=True, tport=states[0]["tport"])
        shard_path = f"/shard/recommend/{users[1]}?howMany=10"
        frames = FrameTransport(router_cfg)
        # past the quarantine that follows the last applied record (the
        # UP of check 5), so that the first answer may be stored
        time.sleep(2 * router_cfg.get_int(
            "oryx.cluster.replica-cache.quarantine-ms") / 1000.0)
        try:
            first = frames.request(hb, "GET", shard_path, None, {}, 120.0)
            state(pipes[0], "reset")
            c0 = state(pipes[0], "shard_cache")
            second = frames.request(hb, "GET", shard_path, None, {}, 120.0)
            c1 = state(pipes[0], "shard_cache")
            relaunched = state(pipes[0])["launches"]
        finally:
            frames.close()
        check(first[0] == 200 and second[:2] == first[:2],
              f"cluster_fast: the framed shard query gave {first[0]}, "
              f"then {second[0]}")
        check(c1["hits"] == c0["hits"] + 1 and c1["epoch"] == c0["epoch"]
              and not any(relaunched.values()),
              f"cluster_fast: shard cache {c0} -> {c1}, launches "
              f"{relaunched}")
        # 7. HTTP/2 on replica 0's door, cleartext and over TLS
        tls_port = state(pipes[0], ("tls_door",
                                    self_signed_pem(work_dir)))
        door = DigestClient(CLUSTER_USER, password)
        h2_paths = paths[2:4]
        h1 = [door.call(ports[0], "GET", p)[:2] for p in h2_paths]
        check(all(st == 200 for st, _ in h1),
              f"cluster_fast: replica 0 gave {[st for st, _ in h1]}")
        h2c = h2_get(ports[0], h2_paths, door, tls=False)
        h2s = h2_get(tls_port, h2_paths, door, tls=True)
        check(h2c == h1 and h2s == h1,
              f"cluster_fast: h2 answers differ from HTTP/1.1: "
              f"{[(a[0], len(a[1])) for a in h2c + h2s]} vs "
              f"{[(a[0], len(a[1])) for a in h1]}")
        metrics = json.loads(client.call(router.port, "GET",
                                         "/metrics")[1])
        cache = metrics["cluster"]["cache"]
        loop_lag = metrics.get("freshness", {}).get("async_loop_lag_ms")
    finally:
        if router is not None:
            router.close()
        stop_replicas(pipes, procs)
    check(all(p.exitcode == 0 for p in procs),
          f"cluster_fast: a replica exited {[p.exitcode for p in procs]}")
    line = {"phase": "cluster_fast", "items": CLUSTER_ITEMS,
            "features": CLUSTER_FEATURES, "replicas": replicas,
            "concurrency": CLUSTER_CLIENTS,
            "load_waited_s": waited_s,
            "router_miss": {"requests": len(miss), "seconds": miss_s,
                            **percentiles(r[2] for r in miss)},
            "router_hit": {"requests": len(hit), "seconds": hit_s,
                           **percentiles(r[2] for r in hit)},
            "router_anonymous_async": {
                "requests": len(anonymous),
                **percentiles(r[2] for r in anonymous)},
            "router_anonymous_threaded": None if phase11 is None
            else phase11["router_anonymous"],
            "coalesce_wave": {"requests": len(wave), **verdicts(wave),
                              **percentiles(r[2] for r in wave)},
            "async_loop_lag_ms": loop_lag,
            "replica0_shard_cache": c1,
            "cache": cache, "scatter": sc,
            "seconds": time.perf_counter() - t_phase}
    log(line)
    return line


# -- phase 13: two regions, the mirror and the autoscaler -----------------------

def region_overlay(work_dir: str, shard: int | None) -> dict:
    """Region B's keys over the port's example config: a ``file://``
    broker of its own, the region's name, and for a replica its shard of
    two.  No DIGEST: region B's doors are open.  A replica (the
    autoscaled member too) reads as ready only with its whole shard
    loaded, so that every routed answer is the exact scan's; its
    commands keep their kernel libraries where phase 1 built them."""
    from oryx_tpu_torch.ops import cuda_build
    broker = "file://" + os.path.join(work_dir, "regions", "broker_b")
    overlay = {"oryx.update-topic.broker": broker,
               "oryx.input-topic.broker": broker,
               "oryx.cluster.region.name": "b",
               "oryx.cluster.heartbeat-interval-ms": 200,
               "oryx.serving.min-model-load-fraction": 1.0,
               "oryx.compile-cache-dir": str(cuda_build.BUILD_DIR.parent)}
    if shard is not None:
        overlay.update({"oryx.cluster.enabled": True,
                        "oryx.cluster.shard": f"{shard}/2",
                        "oryx.cluster.replica-id": f"b-replica-{shard}"})
    return overlay


def write_conf(path: str, overlay: dict) -> str:
    """``als-example.conf`` with ``overlay``'s keys appended (HOCON
    last-wins): the conf file of a command this phase starts."""
    with open(os.path.join(REPO, "oryx_tpu_torch", "conf",
                           "als-example.conf"), encoding="utf-8") as f:
        text = f.read()
    with open(path, "w", encoding="utf-8") as f:
        f.write(text + "\n" + "\n".join(
            f"{k} = {json.dumps(v)}" for k, v in overlay.items()) + "\n")
    return path


def start_command(args: list[str], log_path: str) -> subprocess.Popen:
    """``python -m oryx_tpu_torch <args>`` from the checkout, its output
    appended to ``log_path``."""
    with open(log_path, "ab") as log_f:
        return subprocess.Popen(
            [sys.executable, "-m", "oryx_tpu_torch", *args], cwd=REPO,
            env=cli_env(), stdout=log_f, stderr=subprocess.STDOUT)


def stop_command(proc: subprocess.Popen, what: str,
                 expect_exit: bool = True) -> None:
    """SIGINT, then wait: a clean stop exits 0."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
        rc = None
    if expect_exit:
        check(rc == 0, f"regions: {what} exited {rc} on SIGINT")


def mirror_conf(region: dict, name: str, source: str, dest: str,
                source_region: str, dest_region: str,
                fault: str | None = None) -> str:
    """A mirror's conf: ``source`` -> ``dest`` (file:// brokers of the
    same topic name), its checkpoint under the phase's directory, its
    side door on a port of its own; ``fault`` arms
    ``mirror-crash-mid-replay`` once in that mode (a crashing mirror
    runs unsupervised, so that its process ends at the crash)."""
    overlay = {
        "oryx.update-topic.broker": dest,
        "oryx.input-topic.broker": dest,
        "oryx.cluster.region.name": dest_region,
        "oryx.cluster.region.mirror.source-broker": source,
        "oryx.cluster.region.mirror.source-region": source_region,
        "oryx.cluster.region.mirror.checkpoint-dir":
            os.path.join(region["dir"], f"ckpt_{name}"),
        "oryx.cluster.region.mirror.poll-interval-ms": REGION_POLL_MS,
        "oryx.obs.metrics-port": region["ports"][name]}
    if fault is not None:
        overlay.update({
            "oryx.resilience.faults.mirror-crash-mid-replay.mode": fault,
            "oryx.resilience.faults.mirror-crash-mid-replay.times": 1,
            "oryx.resilience.supervisor.enabled": fault != "crash"})
    return write_conf(os.path.join(
        region["dir"], f"mirror_{name}_{fault or 'run'}.conf"), overlay)


def mirror_metrics(region: dict, name: str) -> dict:
    """A mirror's side-door ``/metrics`` ({} while its process starts)."""
    try:
        status, body, _ = http_call(region["ports"][name], "GET",
                                    "/metrics")
    except OSError:
        return {"counters": {}, "freshness": {}}
    check(status == 200, f"regions: mirror {name}'s /metrics gave {status}")
    return json.loads(body)


def start_mirror(region: dict, name: str, fault: str | None = None):
    """Start mirror ``name`` (``ab``: region A's topic into B's; ``ba``:
    back) with its conf, and keep its process."""
    a = region["a_broker"]
    b = "file://" + os.path.join(region["dir"], "broker_b")
    src, dst, sr, dr = (a, b, "a", "b") if name == "ab" else \
        (b, a, "b", "a")
    conf = mirror_conf(region, name, src, dst, sr, dr, fault)
    proc = start_command(["mirror", "--conf", conf],
                         os.path.join(region["dir"], f"mirror_{name}.log"))
    region["mirrors"][name] = proc
    return proc


def start_region_b(work_dir: str) -> dict:
    """Region B's fleet, started before phase 11 so that its start
    overlaps that phase: two replicas (processes of their own, on the
    card), the router and the autoscaler (``python -m oryx_tpu_torch``
    commands).  They get their model when the A -> B mirror replays
    phase 11's MODEL-REF."""
    rdir = os.path.join(work_dir, "regions")
    os.makedirs(rdir, exist_ok=True)
    a_cfg = cluster_config(cluster_overlay(work_dir, "", None))
    region = {"dir": rdir, "mirrors": {}, "sent_at": None,
              "a_broker": a_cfg.get_string("oryx.update-topic.broker"),
              "topic": a_cfg.get_string("oryx.update-topic.message.topic"),
              "ports": {"ab": free_port(), "ba": free_port(),
                        "router": free_port()},
              "errors": [], "spawned": threading.Event(),
              "stop_trickle": threading.Event(), "trickle": []}
    region["pipes"], region["procs"] = start_replicas(
        [region_overlay(work_dir, shard) for shard in (0, 1)])
    router_conf = write_conf(os.path.join(rdir, "router.conf"), {
        **region_overlay(work_dir, None),
        "oryx.serving.api.port": region["ports"]["router"]})
    region["router"] = start_command(
        ["router", "--conf", router_conf, *device_args()],
        os.path.join(rdir, "router.log"))
    # the members' conf is the autoscaler's: region B's replica keys
    # (the launcher appends the shard, the id and port 0)
    asg = os.path.join(rdir, "asg")
    autoscale_conf = write_conf(os.path.join(rdir, "autoscale.conf"), {
        **region_overlay(work_dir, None),
        "oryx.cluster.autoscale.poll-interval-ms": AUTOSCALE_POLL_MS,
        "oryx.cluster.autoscale.p99-high-ms": AUTOSCALE_P99_HIGH_MS,
        "oryx.cluster.autoscale.p99-low-ms": AUTOSCALE_P99_LOW_MS,
        "oryx.cluster.autoscale.queue-wait-high-ms": 0,
        "oryx.cluster.autoscale.update-lag-high-records": 0,
        "oryx.cluster.autoscale.scale-up-after": 2,
        "oryx.cluster.autoscale.scale-down-after": 3,
        "oryx.cluster.autoscale.cooldown-ms": AUTOSCALE_COOLDOWN_MS,
        "oryx.cluster.autoscale.min-replicas-per-shard": 1,
        "oryx.cluster.autoscale.max-replicas-per-shard": 2,
        "oryx.cluster.autoscale.work-dir": asg})
    region["asg"] = asg
    region["autoscaler"] = start_command(
        ["autoscale", "--conf", autoscale_conf, "--router-url",
         f"http://127.0.0.1:{region['ports']['router']}", *device_args()],
        os.path.join(rdir, "autoscale.log"))
    return region


def stop_region_b(region: dict) -> None:
    """Stop whatever of region B still runs (a failed run's clean-up)."""
    region["stop_trickle"].set()
    thread = region.get("thread")
    if thread is not None:
        thread.join(120)
    for name in ("autoscaler", "router"):
        proc = region.get(name)
        if proc is not None and proc.poll() is None:
            stop_command(proc, name, expect_exit=False)
    for proc in region["mirrors"].values():
        if proc.poll() is None:
            stop_command(proc, "mirror", expect_exit=False)
    if region.get("pipes"):
        stop_replicas(region["pipes"], region["procs"])
        region["pipes"] = None


def region_alive(region: dict, what: str) -> None:
    """Every process of region B that should run still runs."""
    for shard, proc in enumerate(region["procs"]):
        check(proc.is_alive(), f"regions: {what}: replica {shard} exited "
              f"{proc.exitcode}")
    for name in ("router", "autoscaler"):
        rc = region[name].poll()
        check(rc is None, f"regions: {what}: the {name} exited {rc}")
    rc = region["mirrors"]["ab"].poll()
    check(rc is None, f"regions: {what}: the A -> B mirror exited {rc}")


def region_start(region: dict, oracle: tuple) -> None:
    """Phase 11's MODEL-REF is on region A's topic: start the A -> B
    mirror and the background step (``region_background``).  The
    exact answers of its users come from ``oracle``, the whole
    catalog in this process."""
    region["sent_at"] = time.perf_counter()
    full, X, known, _ = oracle
    rng = np.random.default_rng(CLUSTER_SEED + 4)
    users = [f"u{u}" for u in rng.choice(CLUSTER_USERS,
                                         REGION_USERS + REGION_UPS,
                                         replace=False)]
    region["a_users"], region["up_users"] = \
        users[:REGION_USERS], users[REGION_USERS:]
    Q = np.stack([X[int(u[1:])] for u in region["a_users"]])
    region["want"] = dict(zip(region["a_users"], exact_top_n(
        full, 10, Q, [set(known[u]) for u in region["a_users"]])))
    start_mirror(region, "ab")
    region["thread"] = threading.Thread(target=region_background,
                                        args=(region,), daemon=True,
                                        name="RegionB")
    region["thread"].start()


def held_round(port: int, users: list, want: dict, what: str) -> list:
    """/recommend for ``users`` at 8 clients through region B's router,
    each answer the exact scan's (ids in order, rtol 1e-5)."""
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        out = list(pool.map(lambda u: http_call(
            port, "GET", f"/recommend/{u}?howMany=10"), users))
    for u, (status, body, _) in zip(users, out):
        check(status == 200, f"regions: {what} /recommend/{u} gave {status}")
        same_answers([(d["id"], d["value"]) for d in json.loads(body)],
                     want[u], RTOL["float32"], f"regions {what} /recommend/{u}")
    return out


def member_ready(port: int, member_id: str) -> dict | None:
    """The autoscaled member's entry in region B's membership, once it is
    live and ready."""
    status, body, _ = http_call(port, "GET", "/metrics")
    reps = json.loads(body)["cluster"]["membership"]["replicas"] \
        if status == 200 else {}
    r = reps.get(member_id)
    return r if r and r["live"] and r["ready"] else None


def region_background(region: dict) -> None:
    """Region B's side of phases 11-13, beside them: its router's /ready
    and its replicas' loads and routes; check (a)'s round (before any
    member exists, so each replica serves its whole shard); then
    /recommendToAnonymous at ``AUTOSCALE_CLIENTS`` clients (p99 far
    above ``AUTOSCALE_P99_HIGH_MS``) until the autoscaler spawns a
    member; then the trickle — one /recommend at a time, each answer held
    against the exact scan — whose p99 sits between the autoscaler's two
    bounds, so that it neither spawns again nor retires the member while
    it loads and is checked; the trickle notes when the member is ready.
    Any failure is kept for phase 13."""
    try:
        port = region["ports"]["router"]
        pipes, state = region["pipes"], replica_state_of
        wait_for(lambda: region["router"].poll() is None
                 and router_ready(port), "regions: region B's /ready",
                 REGION_WAIT_S)
        region["ready_s"] = time.perf_counter() - region["sent_at"]
        replica_ports(pipes, region["procs"], "regions")
        wait_for(lambda: all(state(c)["loaded"] for c in pipes),
                 "regions: region B's loads and routes", REGION_WAIT_S)
        region["loaded"] = [state(c) for c in pipes]
        # a. the model through the mirror: B's /recommend is the exact
        # scan, and each replica's routed kernel launched
        for conn in pipes:
            conn.send("reset")
            conn.recv()
        region["round_a"] = held_round(port, region["a_users"],
                                       region["want"], "(a)")
        region["states_a"] = [state(c) for c in pipes]
        rng = np.random.default_rng(CLUSTER_SEED + 3)
        paths = round_paths(contexts(rng, CLUSTER_ITEMS, AUTOSCALE_CLIENTS),
                            [None] * AUTOSCALE_CLIENTS)
        t0 = time.perf_counter()
        bursts = 0
        while not os.path.isdir(region["asg"]) or not any(
                f.endswith(".log") for f in os.listdir(region["asg"])):
            check(time.perf_counter() - t0 < AUTOSCALE_PRESSURE_S,
                  "regions: no member spawned under pressure")
            with concurrent.futures.ThreadPoolExecutor(
                    AUTOSCALE_CLIENTS) as pool:
                out = list(pool.map(lambda p: http_call(port, "GET", p),
                                    paths))
            check(all(r[0] == 200 for r in out),
                  f"regions: pressure gave {[r[0] for r in out]}")
            bursts += 1
        region["spawned_at"] = time.perf_counter()
        region["pressure"] = {"bursts": bursts, "clients":
                              AUTOSCALE_CLIENTS,
                              "seconds": region["spawned_at"] - t0}
        region["spawned"].set()
        # the trickle: its users' answers never change in this phase
        n = 0
        while not region["stop_trickle"].is_set():
            for user in region["a_users"]:
                if region["stop_trickle"].is_set():
                    break
                status, body, ms = http_call(
                    port, "GET", f"/recommend/{user}?howMany=10")
                check(status == 200, f"regions: trickle /recommend/{user} "
                      f"gave {status}")
                same_answers(
                    [(d["id"], d["value"]) for d in json.loads(body)],
                    region["want"][user], RTOL["float32"],
                    f"regions trickle /recommend/{user}")
                region["trickle"].append(ms)
                n += 1
                if "member_ready_at" not in region and n % 8 == 0 \
                        and member_ready(port, MEMBER_ID) is not None:
                    region["member_ready_at"] = time.perf_counter()
                time.sleep(TRICKLE_GAP_S)
    except BaseException as e:  # noqa: BLE001 — failed in phase 13
        region["errors"].append(repr(e)[:2000])
        region["spawned"].set()


def router_ready(port: int) -> bool:
    try:
        return http_call(port, "GET", "/ready")[0] in (200, 204)
    except OSError:
        return False


def topic_records(broker_uri: str, topic: str) -> list:
    from oryx_tpu_torch.kafka.inproc import resolve_broker
    broker = resolve_broker(broker_uri)
    ends = broker.latest_offsets(topic)
    return list(broker.read_ranges(topic, [0] * len(ends), ends))


def topic_end(broker_uri: str, topic: str) -> int:
    from oryx_tpu_torch.kafka.inproc import resolve_broker
    return sum(resolve_broker(broker_uri).latest_offsets(topic))


def append_ups(broker_uri: str, topic: str, rows: list) -> None:
    """UP records ``["X", user, vector, []]`` with a ``ts`` header."""
    from oryx_tpu_torch.kafka.inproc import InProcTopicProducer
    producer = InProcTopicProducer(broker_uri, topic)
    ts = str(int(time.time() * 1000))
    producer.send_many([("UP", json.dumps(["X", u, [float(x) for x in v],
                                           []]), {"ts": ts})
                        for u, v in rows])
    producer.close()


def member_launches(log_path: str) -> tuple:
    """(routed kind, its launches after the route) of an autoscaled
    member, from the route and exit lines of its log."""
    routes = log_match(log_path, r"chosen=(\w+) use_lsh=(\w+) .*"
                       r"launches=(\{[^}]*\})")
    exits = log_match(log_path, r"serving: kernel launches=(\{[^}]*\})")
    check(len(routes) >= 1 and len(exits) == 1,
          f"regions: the member's log has {len(routes)} route and "
          f"{len(exits)} exit lines")
    kind, _, at_route = routes[-1]
    at_route, at_exit = json.loads(at_route), json.loads(exits[0])
    return kind, {k: v - at_route.get(k, 0) for k, v in at_exit.items()}


def regions_phase(publisher, work_dir: str, region: dict,
                  phase11: dict | None) -> dict:
    """Phase 13: region B (two replicas, a router and an autoscaler)
    fed by a mirror from region A (phase 11's update topic): the model
    through the mirror, UP propagation, the exactly-once fence across a
    crash and a kill, no ping-pong with a B -> A mirror beside it, and
    a member autoscaled in and out on the card."""
    t_phase = time.perf_counter()
    a_uri, topic = region["a_broker"], region["topic"]
    b_uri = "file://" + os.path.join(region["dir"], "broker_b")
    port = region["ports"]["router"]
    if region["sent_at"] is None:
        # phase 11 did not run: this phase sends its MODEL-REF to A
        publisher.join(CLUSTER_WAIT_S)
        check(publisher.exitcode == 0, f"regions: publishing the model "
              f"failed ({publisher.exitcode})")
        model_dir = os.path.join(work_dir, "cluster_model")
        with open(os.path.join(model_dir, "published.json"),
                  encoding="utf-8") as f:
            manifest = json.load(f)["manifest"]
        oracle = cluster_oracle()
        send_model_ref(cluster_config(cluster_overlay(work_dir, "", None)),
                       model_dir, manifest)
        region_start(region, oracle)
    else:
        oracle = phase11["oracle"]
    full, X, known, _ = oracle
    rng = np.random.default_rng(CLUSTER_SEED + 5)
    a_users, up_users = region["a_users"], region["up_users"]
    want = region["want"]
    pipes = region["pipes"]
    # region_background ran check (a) and the pressure beside phases
    # 11-12; its trickle runs on
    check(region["spawned"].wait(REGION_WAIT_S),
          "regions: region B never spawned a member")
    check(not region["errors"], f"regions: {region['errors']}")
    region_alive(region, "loaded")
    for shard, st in enumerate(region["loaded"]):
        check(st["kind"] in KERNEL_KINDS and not st["route_errors"]
              and st["slice_load_fallbacks"] == 0
              and st["users"] == CLUSTER_USERS,
              f"regions: replica {shard} loaded {st}")
    check(sum(st["items"] for st in region["loaded"]) == CLUSTER_ITEMS,
          f"regions: B's shards hold "
          f"{[st['items'] for st in region['loaded']]}")
    routed = region["round_a"]
    replicas = []
    for shard, st in enumerate(region["states_a"]):
        expected = check_replica_launches(st, shard, "regions")
        replicas.append({"process": f"b-replica-{shard}",
                         "shard": f"{shard}/2", "kind": st["kind"],
                         "kernel": expected, "launches": st["launches"],
                         "model_load_s": st["model_load_s"]})
        log({"phase": "regions_replica", **replicas[-1]})

    # b. UP propagation: 32 new user vectors appended to A, answered by B
    new = rng.standard_normal((REGION_UPS, CLUSTER_FEATURES),
                              dtype=np.float32)
    want_up = dict(zip(up_users, exact_top_n(
        full, 10, new, [set(known[u]) for u in up_users])))
    t0 = time.perf_counter()
    append_ups(a_uri, topic, list(zip(up_users, new)))
    seen = {}
    while len(seen) < len(up_users):
        check(time.perf_counter() - t0 < REGION_PROPAGATION_S,
              f"regions: {len(up_users) - len(seen)} UP records never "
              f"reached region B's answers")
        for u in up_users:
            if u in seen:
                continue
            status, body, _ = http_call(port, "GET",
                                        f"/recommend/{u}?howMany=10")
            got = [(d["id"], d["value"]) for d in json.loads(body)] \
                if status == 200 else []
            if [i for i, _ in got] == [i for i, _ in want_up[u]]:
                same_answers(got, want_up[u], RTOL["float32"],
                             f"regions UP /recommend/{u}")
                seen[u] = (time.perf_counter() - t0) * 1e3
        time.sleep(0.02)
    propagation = sorted(seen.values())
    ab = mirror_metrics(region, "ab")
    steady = []
    for _ in range(5):
        g = mirror_metrics(region, "ab")["freshness"]
        if g.get("mirror_lag_records") == 0:
            steady.append(g["cross_region_staleness_ms"])
        time.sleep(0.05)
    check(steady, "regions: the A -> B mirror never read as drained")

    # c. the exactly-once fence: a partition, a crash between the replay
    # and the checkpoint, a kill inside the same window, then the heal
    region["mirrors"]["ba"] = start_mirror(region, "ba")
    stop_command(region["mirrors"]["ab"], "the A -> B mirror")
    backlog = [(f"bk{j}", np.full(CLUSTER_FEATURES, 1e-3 * (j % 97),
                                  np.float32))
               for j in range(REGION_BACKLOG)]
    append_ups(a_uri, topic, backlog)
    t_heal = time.perf_counter()
    crashed = start_mirror(region, "ab", fault="crash")
    try:
        rc = crashed.wait(120)
    except subprocess.TimeoutExpired:
        crashed.kill()
        rc = None
    crash_log = os.path.join(region["dir"], "mirror_ab.log")
    check(rc is not None and bool(log_match(
        crash_log, r"Fault fired: mirror-crash-mid-replay mode=crash"))
        and bool(log_match(crash_log, r"InjectedCrash")),
        f"regions: the crash-armed mirror exited {rc} without its crash")
    held = start_mirror(region, "ab", fault="hold")
    wait_for(lambda: held.poll() is None and mirror_metrics(
        region, "ab")["counters"].get("mirror_records_replayed", 0) > 0
        and bool(log_match(crash_log, r"Fault fired: "
                           r"mirror-crash-mid-replay mode=hold")),
        "regions: the held mirror's replay", 120)
    held_replayed = mirror_metrics(region, "ab")["counters"][
        "mirror_records_replayed"]
    held.kill()  # a kill inside the window: no checkpoint is written
    held.wait(30)
    healed = start_mirror(region, "ab")
    wait_for(lambda: healed.poll() is None and mirror_metrics(
        region, "ab")["freshness"].get("mirror_lag_records") == 0,
        "regions: the healed mirror's drain", 120)
    catch_up_s = time.perf_counter() - t_heal
    ab = mirror_metrics(region, "ab")
    dedup = ab["counters"].get("mirror_dedup_skips", 0)
    check(dedup == held_replayed,
          f"regions: {dedup} dedup skips after the kill, "
          f"{held_replayed} records sent before it")
    b_records = topic_records(b_uri, topic)
    triples = [(km.headers["origin-region"], km.headers["origin-partition"],
                km.headers["origin-offset"]) for km in b_records
               if km.headers and "origin-region" in km.headers]
    check(len(triples) == len(set(triples)),
          f"regions: {len(triples) - len(set(triples))} duplicated origin "
          f"triples in region B's topic")
    bk = [json.loads(km.message)[1] for km in b_records
          if km.key == "UP" and json.loads(km.message)[1].startswith("bk")]
    check(len(bk) == REGION_BACKLOG and len(set(bk)) == REGION_BACKLOG,
          f"regions: the backlog of {REGION_BACKLOG} landed {len(bk)} "
          f"times ({len(set(bk))} distinct)")

    # e. the autoscaled member: live on /topology, exact answers
    member_log = os.path.join(region["asg"], f"{MEMBER_ID}.log")
    wait_for(lambda: "member_ready_at" in region or region["errors"],
             "regions: the autoscaled member's load", REGION_WAIT_S)
    check(not region["errors"], f"regions: {region['errors']}")
    region_alive(region, "member ready")
    topology = json.loads(http_call(port, "GET", "/admin/topology")[1])
    check(topology["topologies"]["2"]["replicas"] == 3,
          f"regions: /admin/topology lists {topology}")
    mport = int(member_ready(port, MEMBER_ID)["url"].rsplit(":", 1)[1])
    held_round(port, a_users, want, "(3 replicas)")
    # the member's own door (its shard alone), so that it serves on the
    # card whatever the router's rotation gave it
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        own = list(pool.map(lambda u: http_call(
            mport, "GET", f"/recommend/{u}?howMany=10"), a_users))
    check(all(r[0] == 200 and len(json.loads(r[1])) == 10 for r in own),
          f"regions: the member's own /recommend gave "
          f"{sorted({r[0] for r in own})}")
    def route_of_member() -> dict:
        status, body, _ = http_call(mport, "GET", "/metrics")
        if status != 200:
            return {}
        metrics = json.loads(body).get("model_metrics") or {}
        return metrics.get("kernel_route") or {}

    # ready is the load; the route is measured right after it
    wait_for(lambda: route_of_member().get("chosen") is not None,
             "regions: the member's route", REGION_WAIT_S)
    member_route = route_of_member()
    # calm: the trickle stops, no traffic reads as calm, the member goes
    region["stop_trickle"].set()
    region["thread"].join(60)
    check(not region["errors"], f"regions: {region['errors']}")
    t_calm = time.perf_counter()
    autoscale_log = os.path.join(region["dir"], "autoscale.log")
    wait_for(lambda: json.loads(http_call(
        port, "GET", "/admin/topology")[1])["topologies"]["2"][
            "replicas"] == 2 and bool(log_match(
                member_log, r"serving: kernel launches="))
        and bool(log_match(autoscale_log, r"autoscale action: .*retire")),
        "regions: the member's retirement", REGION_WAIT_S)
    retire_s = time.perf_counter() - t_calm
    with open(member_log, encoding="utf-8", errors="replace") as f:
        print(f"--- regions: the member's log\n{f.read()[-6000:]}",
              file=sys.stderr)
    kind, served = member_launches(member_log)
    check(kind == member_route.get("chosen") and kind in KERNEL_KINDS,
          f"regions: the member routed {kind} ({member_route})")
    expected = next(k for k, v in KERNELS.items() if v[2] == kind)
    check(served[expected] > 0, f"regions: the member's {expected} "
          f"launched no time: {served}")
    actions = log_match(autoscale_log, r"autoscale action: (\{[^}]*\})")
    kinds = [re.search(r"'kind': '(\w+)'", a).group(1) for a in actions]
    check(kinds == ["spawn", "retire"],
          f"regions: autoscale actions {actions}")
    member = {"process": MEMBER_ID, "shard": "0/2", "kind": kind,
              "kernel": expected, "launches": served,
              "own_door": {"requests": len(own),
                           **percentiles(r[2] for r in own)}}
    log({"phase": "regions_replica", **member})

    # d. no ping-pong: region B's fleet stops, records born in B go to A
    # through the B -> A mirror and come back to no one
    stop_command(region["autoscaler"], "the autoscaler")
    stop_command(region["router"], "region B's router")
    stop_replicas(pipes, region["procs"])
    region["pipes"] = None
    check(all(p.exitcode == 0 for p in region["procs"]),
          f"regions: a replica exited {[p.exitcode for p in region['procs']]}")
    a_end, b_end = topic_end(a_uri, topic), topic_end(b_uri, topic)
    append_ups(b_uri, topic, [(f"bb{j}", np.ones(CLUSTER_FEATURES,
                                                 np.float32))
                              for j in range(REGION_BORN_B)])
    try:
        wait_for(lambda: topic_end(a_uri, topic) == a_end + REGION_BORN_B
                 and mirror_metrics(region, "ab")["counters"].get(
                     "mirror_loop_drops", 0) >= REGION_BORN_B,
                 "regions: records born in B through both mirrors", 120)
    except RuntimeError:
        # what the mirrors did: their counters, their logs' ends
        for name in ("ab", "ba"):
            proc = region["mirrors"][name]
            print(f"--- regions: mirror {name} (exit {proc.poll()}), "
                  f"A's end {topic_end(a_uri, topic)} of "
                  f"{a_end + REGION_BORN_B}, counters "
                  f"{mirror_metrics(region, name)['counters']}",
                  file=sys.stderr)
            with open(os.path.join(region["dir"], f"mirror_{name}.log"),
                      encoding="utf-8", errors="replace") as f:
                print(f.read()[-6000:], file=sys.stderr)
        raise
    ends = []
    for _ in range(3):
        time.sleep(3 * REGION_POLL_MS / 1000)
        ends.append((topic_end(a_uri, topic), topic_end(b_uri, topic)))
    check(ends == [(a_end + REGION_BORN_B, b_end + REGION_BORN_B)] * 3,
          f"regions: the topics moved after convergence: {ends}")
    ab, ba = mirror_metrics(region, "ab"), mirror_metrics(region, "ba")
    loop_drops = {"ab": ab["counters"].get("mirror_loop_drops", 0),
                  "ba": ba["counters"].get("mirror_loop_drops", 0)}
    check(loop_drops["ab"] > 0 and loop_drops["ba"] > 0,
          f"regions: loop drops {loop_drops}")
    for name in ("ab", "ba"):
        stop_command(region["mirrors"][name], f"mirror {name}")
    lat = sorted(r[2] for r in routed)
    line = {"phase": "regions", "items": CLUSTER_ITEMS,
            "features": CLUSTER_FEATURES,
            "replicas": replicas + [member],
            "b_ready_s": region["ready_s"],
            "b_recommend": {"requests": len(routed),
                            **percentiles(lat)},
            "up_records": REGION_UPS,
            "up_to_answer_ms": {"p50": propagation[len(propagation) // 2],
                                "max": propagation[-1]},
            "mirror_lag_records": ab["freshness"].get("mirror_lag_records"),
            "steady_staleness_ms": statistics.median(steady),
            "backlog": REGION_BACKLOG, "catch_up_s": catch_up_s,
            "catch_up_records_per_s": REGION_BACKLOG / catch_up_s,
            "mirror_dedup_skips": dedup,
            "mirror_loop_drops": loop_drops,
            "mirror_heartbeat_drops": {
                "ab": ab["counters"].get("mirror_heartbeat_drops", 0),
                "ba": ba["counters"].get("mirror_heartbeat_drops", 0)},
            "autoscale": {
                "signal": f"p99 > {AUTOSCALE_P99_HIGH_MS} ms "
                          f"(/recommendToAnonymous at "
                          f"{AUTOSCALE_CLIENTS} clients)",
                **region["pressure"],
                "spawn_to_member_ready_s":
                    region["member_ready_at"] - region["spawned_at"],
                "retire_s": retire_s,
                "trickle": {"requests": len(region["trickle"]),
                            **percentiles(region["trickle"] or [0.0])},
                "actions": len(actions)},
            "seconds": time.perf_counter() - t_phase}
    log(line)
    return line


# -- phase 14: the sharded speed layer over the Kafka wire broker ------------

def shard_generation(work_dir: str) -> None:
    """Phase 5b's data and generation, for ``--phases speed_shard``
    without ``lambda``: the 250,000 loop lines (no 5a data) and one batch
    generation of the port's batch layer on the card, which publishes
    the sliced MODEL-REF phase 14 copies."""
    from oryx_tpu_torch.lambda_rt.batch import BatchLayer
    t0 = time.perf_counter()
    lambda_data(work_dir, ml20m=False)
    batch = BatchLayer(loop_config(work_dir), device=DEVICE)
    try:
        batch.run_one_generation()
    finally:
        batch.close()
    log({"phase": "speed_shard_generation",
         "seconds": time.perf_counter() - t0})
    free()


def shard_model_ref(work_dir: str) -> str:
    """Phase 5b's MODEL-REF record (the manifest envelope and all), off
    the loop's ``file://`` update topic."""
    from oryx_tpu_torch.kafka.inproc import resolve_broker
    cfg = loop_config(work_dir)
    broker = resolve_broker(cfg.get_string("oryx.update-topic.broker"))
    topic = cfg.get_string("oryx.update-topic.message.topic")
    ends = broker.latest_offsets(topic)
    refs = [m.message for m in broker.read_ranges(topic, [0] * len(ends),
                                                  ends)
            if m.key == "MODEL-REF"]
    check(len(refs) == 1, f"speed_shard: {len(refs)} MODEL-REF records "
          f"on the loop's update topic")
    return refs[0]


def shard_overlay(shards: dict, shard: int, crash: bool) -> dict:
    """A worker's keys over the port's example config: the wire broker,
    the checkpoint directory, its side door, a 1 s micro-batch, and the
    hold on its first UP publish; worker 0's first incarnation also
    arms the crash point between the publishes and the commit."""
    from oryx_tpu_torch.ops import cuda_build
    overlay = {
        "oryx.id": "shard-smoke",
        "oryx.input-topic.broker": shards["bootstrap"],
        "oryx.update-topic.broker": shards["bootstrap"],
        "oryx.speed.checkpoint-dir": shards["checkpoint_dir"],
        "oryx.speed.streaming.generation-interval-sec": 1,
        "oryx.obs.metrics-port": shards["ports"][shard],
        "oryx.resilience.supervisor.enabled": False,
        "oryx.compile-cache-dir": str(cuda_build.BUILD_DIR.parent)}
    if crash:
        overlay["oryx.resilience.faults.speed-publish"] = {
            "mode": "delay", "times": 1, "delay-ms": SHARD_HOLD_MS}
    if crash and shard == 0:
        overlay["oryx.resilience.faults.speed-crash-mid-batch"] = {
            "mode": "crash", "times": 1}
    return overlay


def start_speed_shard(shards: dict, shard: int, crash: bool):
    name = f"shard{shard}" + ("" if crash else "_restart")
    conf = write_conf(os.path.join(shards["dir"], f"{name}.conf"),
                      shard_overlay(shards, shard, crash))
    return start_command(["speed", "--shard", f"{shard}/{SHARD_COUNT}",
                          "--conf", conf, *device_args()],
                         shards["logs"][shard])


def start_speed_shards(work_dir: str) -> dict:
    """Phase 14's set-up, started right after phase 5b so that the two
    workers' loads overlap the phases between: the port's
    MiniKafkaBroker in this process, the topics made by ``kafka-setup``
    at its address (the example config's partition counts), phase 5b's
    MODEL-REF copied onto the wire update topic, and ``speed --shard
    i/2`` for both slices on the card."""
    from oryx_tpu_torch.common.config import from_file
    from oryx_tpu_torch.kafka.client import KafkaTopicProducer
    from oryx_tpu_torch.kafka.mini_broker import MiniKafkaBroker
    t0 = time.perf_counter()
    shard_dir = os.path.join(work_dir, "speed_shard")
    os.makedirs(shard_dir)
    mini = MiniKafkaBroker()
    shards = {"dir": shard_dir, "mini": mini, "bootstrap": mini.bootstrap,
              "checkpoint_dir": os.path.join(shard_dir, "checkpoints"),
              "ports": [free_port() for _ in range(SHARD_COUNT)],
              "logs": [os.path.join(shard_dir, f"shard{i}.log")
                       for i in range(SHARD_COUNT)],
              "procs": [], "model_ref": shard_model_ref(work_dir)}
    try:
        conf = write_conf(os.path.join(shard_dir, "setup.conf"),
                          shard_overlay(shards, 0, False))
        setup = subprocess.run(
            [sys.executable, "-m", "oryx_tpu_torch", "kafka-setup", "--conf",
             conf], cwd=REPO, env=cli_env(), capture_output=True, text=True,
            timeout=120)
        check(setup.returncode == 0 and setup.stdout.count(": exists") == 2,
              f"speed_shard: kafka-setup exited {setup.returncode}: "
              f"{setup.stdout}{setup.stderr[-2000:]}")
        shards["setup_s"] = time.perf_counter() - t0
        cfg = from_file(conf)
        shards["in_topic"] = cfg.get_string("oryx.input-topic.message.topic")
        shards["up_topic"] = cfg.get_string(
            "oryx.update-topic.message.topic")
        KafkaTopicProducer(mini.bootstrap, shards["up_topic"]).send(
            "MODEL-REF", shards["model_ref"])
        shards["t_spawn"] = time.perf_counter()
        shards["procs"] = [start_speed_shard(shards, i, True)
                           for i in range(SHARD_COUNT)]
    except BaseException:
        stop_speed_shards(shards)
        raise
    return shards


def stop_speed_shards(shards: dict | None) -> None:
    if not shards:
        return
    for proc in shards["procs"]:
        if proc.poll() is None:
            proc.kill()
        proc.wait(30)
    shards["mini"].close()


def shard_metrics(shards: dict, shard: int) -> dict:
    """A worker's side-door ``/metrics`` ({} while its process starts)."""
    try:
        status, body, _ = http_call(shards["ports"][shard], "GET",
                                    "/metrics")
    except OSError:
        return {"counters": {}, "freshness": {}}
    return json.loads(body) if status == 200 else \
        {"counters": {}, "freshness": {}}


def log_seconds(path: str, first: str, last: str) -> float | None:
    """Seconds between the log lines matching ``first`` and ``last``
    (the first of each), from their timestamps."""
    import datetime
    stamps = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            for key, pattern in (("a", first), ("b", last)):
                if key not in stamps and re.search(pattern, line):
                    m = re.match(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d+)",
                                 line)
                    if m:
                        stamps[key] = datetime.datetime.strptime(
                            m.group(1), "%Y-%m-%d %H:%M:%S,%f")
    if len(stamps) < 2:
        return None
    return (stamps["b"] - stamps["a"]).total_seconds()


def generation_snapshot(model_ref: str) -> tuple:
    """(the generation's PMML path, X ids, Y ids, implicit flag) and a
    function giving its X and Y vectors by id with their Gramians in
    float64, from the MODEL-REF's slices on the local store: the speed
    model's state before any micro-batch."""
    from oryx_tpu_torch.app.als import slices
    from oryx_tpu_torch.common import pmml as pmml_io
    path, model_dir, manifest = slices.parse_model_ref(model_ref)
    model_dir = model_dir or path.rsplit("/", 1)[0]
    doc = pmml_io.read(path)
    features = int(pmml_io.get_extension_value(doc, "features"))

    def vectors() -> dict:
        snap = {"X": {}, "Y": {}}
        rows = {"X": [], "Y": []}
        for entry in manifest["slices"]:
            ids, matrix, _ = slices.read_slice(model_dir, entry, features)
            rows["Y"].append(np.asarray(matrix, np.float64))
            snap["Y"].update(zip(ids, rows["Y"][-1]))
        x_ids, X, _ = slices.read_x_known(model_dir, manifest["x"],
                                          features)
        rows["X"].append(np.asarray(X, np.float64))
        snap["X"].update(zip(x_ids, rows["X"][-1]))
        for side in ("X", "Y"):
            m = np.concatenate(rows[side])
            snap[f"{side}t{side}"] = m.T @ m
        return snap

    return (pmml_io.get_extension_content(doc, "XIDs"),
            pmml_io.get_extension_content(doc, "YIDs"),
            pmml_io.get_extension_value(doc, "implicit") == "true", vectors)


def speed_shard_phase(shards: dict) -> dict:
    """Phase 14: phase 5b's 2,000 /pref events through the port's
    KafkaTopicProducer onto the wire input topic, folded by two ``speed
    --shard i/2`` workers on the card, worker 0 killed between its
    publishes and its commit and restarted on its checkpoint; checks
    a-d and the ``speed_shard`` line."""
    from oryx_tpu_torch.cluster.sharding import is_local_item
    from oryx_tpu_torch.kafka.client import KafkaTopicProducer
    from oryx_tpu_torch.kafka.inproc import resolve_broker
    from oryx_tpu_torch.lambda_rt.speed_checkpoint import (
        H_SPEED_BATCH, H_SPEED_SEQ, H_SPEED_SHARD)
    t_phase = time.perf_counter()
    broker = resolve_broker(shards["bootstrap"])
    in_topic, up_topic = shards["in_topic"], shards["up_topic"]
    procs, logs = shards["procs"], shards["logs"]
    x_ids, y_ids, implicit, vectors = generation_snapshot(
        shards["model_ref"])

    # both workers loaded the generation and pinned their fence
    def loaded(i: int) -> bool:
        check(procs[i].poll() is None, f"speed_shard: worker {i} exited "
              f"{procs[i].poll()} while loading:\n"
              + open(logs[i], errors="replace").read()[-3000:])
        fresh = shard_metrics(shards, i)["freshness"]
        return bool(log_match(logs[i], "Model updated")) \
            and fresh.get("update_lag_records") == 0 \
            and fresh.get("speed_checkpoint_age_sec") is not None

    loaded_s = []
    for i in range(SHARD_COUNT):
        wait_for(lambda i=i: loaded(i), f"speed_shard: worker {i}'s load",
                 SHARD_WAIT_S)
        loaded_s.append(time.perf_counter() - shards["t_spawn"])
    waited_s = time.perf_counter() - t_phase

    # the events, all in one Produce request: every worker's micro-batch
    # reads all of them or none
    _, _, events = pref_events(x_ids, y_ids)
    ts = int(time.time() * 1000)
    lines = [f"{u},{i},{v},{ts + j}" for j, (u, i, v) in enumerate(events)]
    in_before = broker.latest_offsets(in_topic)
    t_post = time.perf_counter()
    KafkaTopicProducer(shards["bootstrap"], in_topic).send_many(
        [(None, line, {"ts": str(ts)}) for line in lines])
    in_ends = broker.latest_offsets(in_topic)
    check(sum(in_ends) - sum(in_before) == PREF_EVENTS,
          f"speed_shard: {sum(in_ends) - sum(in_before)} of {PREF_EVENTS} "
          f"events on the input topic")
    new_data = broker.read_ranges(in_topic, in_before, in_ends)
    # the float64 loop on the generation, while the workers fold
    want = expected_ups(new_data, vectors(), implicit)

    # a. worker 0 dies after its publishes, before its commit
    try:
        crash_rc = procs[0].wait(SHARD_WAIT_S)
    except subprocess.TimeoutExpired:
        crash_rc = None
    crash_s = time.perf_counter() - t_post
    worker0_log = open(logs[0], errors="replace").read()
    check(crash_rc is not None and "injected crash at "
          "speed-crash-mid-batch" in worker0_log,
          f"speed_shard: worker 0 did not die at the crash point "
          f"({crash_rc}):\n{worker0_log[-3000:]}")
    ckpt_path = [os.path.join(shards["checkpoint_dir"],
                              f"shard-{i}-of-{SHARD_COUNT}",
                              "speed-checkpoint.json")
                 for i in range(SHARD_COUNT)]

    def checkpoint(i: int) -> dict:
        with open(ckpt_path[i], encoding="utf-8") as f:
            return json.load(f)

    staged = checkpoint(0)["pending"]
    check(staged is not None and staged["ends"] == in_ends,
          f"speed_shard: worker 0's checkpoint after the crash: {staged}")
    n_staged = len(staged["updates"])
    check(n_staged > 0, "speed_shard: worker 0 staged no update")
    # the restart on the same checkpoint, no fault: every staged record
    # is found in the log (so all had landed before the crash), none is
    # republished
    t_restart = time.perf_counter()
    procs[0] = start_speed_shard(shards, 0, False)
    # worker 1 folds and commits its half meanwhile
    wait_for(lambda: shard_metrics(shards, 1)["freshness"].get(
        "input_lag_records") == 0, "speed_shard: worker 1's commit",
        SHARD_WAIT_S)
    fresh1 = shard_metrics(shards, 1)["freshness"]
    check(fresh1.get("micro_batch_records") == PREF_EVENTS,
          f"speed_shard: worker 1 read {fresh1}")
    wait_for(lambda: procs[0].poll() is None and shard_metrics(
        shards, 0)["counters"].get("speed_shard_dedup_skips") is not None
        and shard_metrics(shards, 0)["freshness"].get(
            "input_lag_records") == 0,
        "speed_shard: worker 0's recovery", SHARD_WAIT_S)
    recovery_s = time.perf_counter() - t_restart
    dedup = shard_metrics(shards, 0)["counters"]["speed_shard_dedup_skips"]
    check(dedup == n_staged, f"speed_shard: {dedup} dedup skips for "
          f"{n_staged} staged updates")
    # both workers stop while the topic is read
    for proc in procs:
        proc.send_signal(signal.SIGINT)

    # b. exactly once: unique identities, each pair's X and Y once, each
    # worker on its own ring slots
    ends = broker.latest_offsets(up_topic)
    ups = [km for km in broker.read_ranges(up_topic, [0] * len(ends), ends)
           if km.key == "UP"]
    triples = [tuple((km.headers or {}).get(h) for h in (
        H_SPEED_SHARD, H_SPEED_BATCH, H_SPEED_SEQ)) for km in ups]
    check(None not in {t[0] for t in triples}
          and len(set(triples)) == len(triples),
          f"speed_shard: {len(triples) - len(set(triples))} repeated "
          f"(shard, batch, seq) identities")
    got, per_worker = {}, {f"{i}/{SHARD_COUNT}": 0
                           for i in range(SHARD_COUNT)}
    for km, (tag, _, _) in zip(ups, triples):
        kind, id_, vec, other = json.loads(km.message)
        key = (kind, id_, other[0])
        check(key not in got, f"speed_shard: {key} published twice")
        got[key] = np.asarray(vec, np.float64)
        item = id_ if kind == "Y" else other[0]
        check(is_local_item(item, int(tag.split("/")[0]), SHARD_COUNT),
              f"speed_shard: worker {tag} folded {item}, not its own")
        per_worker[tag] += 1
    check(per_worker[f"0/{SHARD_COUNT}"] == n_staged,
          f"speed_shard: worker 0 staged {n_staged} updates, the topic "
          f"holds {per_worker[f'0/{SHARD_COUNT}']} (the restart "
          f"republished, or the crash lost some)")
    pairs = {(u, i) for u, i, _ in events}
    check(set(got) == set(want)
          and {(k[1], k[2]) for k in want if k[0] == "X"} == pairs
          and {(k[2], k[1]) for k in want if k[0] == "Y"} == pairs,
          f"speed_shard: {len(got)} UP records for {len(want)} expected "
          f"({len(set(got) ^ set(want))} differ) over {len(pairs)} pairs")

    # c. the vectors against the float64 host loop on the generation
    err = max(float(np.max(np.abs(got[k] - v) / (FOLD_ATOL + FOLD_RTOL
                                                * np.abs(v))))
              for k, v in want.items())
    check(err <= 1.0, f"speed_shard: an UP vector is {err} times the "
          f"fold-in tolerance from the float64 loop")
    max_abs = max(float(np.max(np.abs(got[k] - v))) for k, v in want.items())

    # d. the offsets: each group's commits over the wire and each
    # checkpoint's fence at the input's end, nothing pending
    for i in range(SHARD_COUNT):
        group = f"OryxGroup-SpeedLayer-shard-smoke-{i}x{SHARD_COUNT}"
        committed = broker.get_offsets(group, in_topic)
        check(committed == in_ends, f"speed_shard: worker {i}'s group "
              f"committed {committed}, the input ends at {in_ends}")
        doc = checkpoint(i)
        check(doc["pending"] is None and [doc["input"].get(str(p)) for p
                                          in range(len(in_ends))] == in_ends,
              f"speed_shard: worker {i}'s checkpoint {doc['input']}, "
              f"pending {doc['pending'] is not None}")
    for i, proc in enumerate(procs):
        try:
            rc = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
            rc = None
        check(rc == 0, f"speed_shard: worker {i} exited {rc} on SIGINT")

    # e. each worker's load, micro-batch, and the events it folded
    workers = []
    owned_total = 0
    for i in range(SHARD_COUNT):
        tag = f"{i}/{SHARD_COUNT}"
        batch = [m for m in log_match(
            logs[i], r"Micro-batch of (\d+) records: (\d+) updates built "
                     r"in ([0-9.]+) s \((\d+) remote events skipped")]
        check(len(batch) == 1 and int(batch[0][0]) == PREF_EVENTS,
              f"speed_shard: worker {i}'s micro-batches: {batch}")
        skipped = int(batch[0][3])
        owned = sum(is_local_item(it, i, SHARD_COUNT) for _, it, _ in events)
        check(skipped == PREF_EVENTS - owned,
              f"speed_shard: worker {i} skipped {skipped}, the ring gives "
              f"it {owned} of {PREF_EVENTS}")
        owned_total += owned
        workers.append({
            "shard": tag, "spawn_to_loaded_s": loaded_s[i],
            "model_load_s": log_seconds(logs[i], "Loading new model",
                                        "Model updated"),
            "build_s": float(batch[0][2]),
            "micro_batch_s": (fresh1["micro_batch_duration_ms"] / 1e3
                              if i == 1 else None),
            "events_folded": owned, "skipped_remote_events": skipped,
            "up_records": per_worker[tag]})
    check(owned_total == PREF_EVENTS, "speed_shard: the ring split lost "
          "events")
    line = {"phase": "speed_shard", "broker": "MiniKafkaBroker (wire)",
            "events": PREF_EVENTS, "pairs": len(pairs),
            "workers": workers, "hold_ms": SHARD_HOLD_MS,
            "setup_s": shards["setup_s"], "waited_for_loads_s": waited_s,
            "post_to_crash_s": crash_s, "crash_exit_code": crash_rc,
            "staged_updates": n_staged, "dedup_skips": dedup,
            "restart_to_recovery_s": recovery_s, "up_records": len(ups),
            "up_max_abs_err": max_abs, "up_err_of_tolerance": err,
            "seconds": time.perf_counter() - t_phase}
    log(line)
    return line

# -- phase 15: several devices on one card -----------------------------------

def mesh_of_one_card():
    """A mesh of ``MESH_ENTRIES`` entries of the one card: the code two
    cards run, on one."""
    import torch
    from oryx_tpu_torch.parallel.mesh import Mesh
    dev = torch.device("cuda", 0) if DEVICE == "cuda" else DEVICE
    return Mesh([dev] * MESH_ENTRIES)


def mesh_models(keep: dict) -> tuple:
    """(phase 3's one-entry 5M x 250 bfloat16 model, its sharded twin):
    the twin is an ``ALSServingModel(item_shards=2, mesh=...)`` loaded
    with the same rows; without phase 3 the model is built from the
    vectors' seed."""
    from oryx_tpu_torch.app.als.serving_model import ALSServingModel
    single = keep.pop("5M_bf16_exact", None)
    if single is None:
        Y = first_items()
        single = build_model(FEATURES, Y, np.zeros((1, FEATURES),
                                                    np.float32),
                             {}, "bfloat16")
        del Y
        single.refresh_route()
    t0 = time.perf_counter()
    twin = ALSServingModel(FEATURES, True, dtype="bfloat16", device=DEVICE,
                           item_shards=MESH_ENTRIES, mesh=mesh_of_one_card())
    vecs, _, row_ids = single.Y.host_arrays()
    twin.Y.load_rows(row_ids, vecs)
    del vecs
    twin.Y.shard_arrays_versioned()
    return single, twin, time.perf_counter() - t0


def near_tie_rows(got: list, want: list, rtol: float, what: str) -> int:
    """Rows whose ids differ from ``want``'s: each must be a near-tie,
    every position's score within ``rtol`` of the row's largest score;
    the count."""
    differ = 0
    for g, w in zip(got, want):
        check(len(g) == len(w), f"{what}: {len(g)} answers, not {len(w)}")
        gs = np.array([v for _, v in g])
        ws = np.array([v for _, v in w])
        scale = max(float(np.abs(ws).max()), 1e-30)
        check(bool(np.all(np.abs(gs - ws) <= rtol * scale)),
              f"{what}: scores {gs} against {ws}")
        if [i for i, _ in g] != [i for i, _ in w]:
            differ += 1
    return differ


def window_ms(torch, model, Q: np.ndarray, reps: int = 5) -> float:
    """Median host milliseconds of one served window (``top_n_batch``,
    the answers on the host)."""
    model.top_n_batch(10, Q)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.top_n_batch(10, Q)
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def mesh_serving(torch, single, twin) -> dict:
    """15a: the sharded model's answers against the one-entry model's for
    ``MESH_USERS`` users at each of ``MESH_WINDOWS``."""
    rng = np.random.default_rng(SEED + 23)
    Q = rng.standard_normal((MESH_USERS, FEATURES), dtype=np.float32)
    out = {}
    for b in MESH_WINDOWS:
        ties = 0
        for s in range(0, MESH_USERS, b):
            ties += near_tie_rows(twin.top_n_batch(10, Q[s:s + b]),
                                  single.top_n_batch(10, Q[s:s + b]),
                                  RTOL["bfloat16"], f"mesh B={b}")
        check(ties <= MESH_TIE_SHARE * MESH_USERS,
              f"mesh B={b}: {ties} rows differ by near-ties, more than "
              f"{MESH_TIE_SHARE:.0%}")
        out[b] = {"near_tie_rows": ties,
                  "sharded_ms": window_ms(torch, twin, Q[:b]),
                  "single_ms": window_ms(torch, single, Q[:b])}
    return out


def mesh_ratings(work_dir: str):
    """A random sample of phase 5a's interactions (drawn here when phase
    5 did not run), as many as keep both dense layouts within
    ``MESH_ALS_SLOTS`` slots, re-indexed over the users and items it
    holds."""
    from oryx_tpu_torch.app.als.common import ParsedRatings
    from oryx_tpu_torch.bench.train import synthesize_movielens
    path = os.path.join(work_dir, "ml20m.npz")
    if os.path.exists(path):
        data = np.load(path)
        users, items, values = data["users"], data["items"], data["values"]
    else:
        users, items, values, _, _ = synthesize_movielens(
            ML_USERS, ML_ITEMS, ML_RATINGS // 10, seed=TRAIN_SEED)
    perm = np.random.default_rng(TRAIN_SEED + 3).permutation(len(users))

    def slots(n):
        # rows padded to the entries, each as wide as the longest row
        # rounded up to a power of two, on both sides
        out = 0
        for ids in (users[perm[:n]], items[perm[:n]]):
            counts = np.bincount(ids)
            rows = int(np.count_nonzero(counts))
            out += (MESH_ENTRIES * -(-rows // MESH_ENTRIES)
                    * (1 << int(counts.max() - 1).bit_length()))
        return out

    lo, hi = 1, len(users)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if slots(mid) <= MESH_ALS_SLOTS:
            lo = mid
        else:
            hi = mid - 1
    u, ui = np.unique(users[perm[:lo]], return_inverse=True)
    i, ii = np.unique(items[perm[:lo]], return_inverse=True)
    return ParsedRatings([str(x) for x in u], [str(x) for x in i],
                         ui.astype(np.int32), ii.astype(np.int32),
                         values[perm[:lo]].astype(np.float32)), slots(lo)


def mesh_als(torch, work_dir: str, mesh) -> dict:
    """15b: ``train_als_distributed`` in both modes against
    ``train_als`` at the same seed."""
    from oryx_tpu_torch.app.als.trainer import train_als
    from oryx_tpu_torch.common.config import get_default
    from oryx_tpu_torch.parallel import train_als_distributed
    defaults = get_default()
    lam = defaults.get_double("oryx.als.hyperparams.lambda")
    alpha = defaults.get_double("oryx.als.hyperparams.alpha")
    ratings, slots = mesh_ratings(work_dir)
    args = (ratings, TRAIN_RANK, lam, alpha, True, MESH_ALS_SWEEPS)
    t0 = time.perf_counter()
    single = train_als(*args, seed=TRAIN_SEED, device=DEVICE)
    out = {"pairs": len(ratings.values), "users": len(ratings.user_ids),
           "items": len(ratings.item_ids), "dense_slots": slots,
           "single_s": time.perf_counter() - t0}
    for mode in ("gather", "ring"):
        free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dist = train_als_distributed(*args, mesh, seed=TRAIN_SEED,
                                     mode=mode)
        seconds = time.perf_counter() - t0
        err = max(float(np.abs(dist.X - single.X).max()),
                  float(np.abs(dist.Y - single.Y).max()))
        for side in ("X", "Y"):
            a, b = getattr(dist, side), getattr(single, side)
            check(bool(np.all(np.abs(a - b)
                              <= MESH_ALS_TOL + MESH_ALS_TOL * np.abs(b))),
                  f"mesh als {mode}: {side} is {err} from train_als")
        out[mode] = {"s": seconds, "max_abs_err": err,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
    return out


def mesh_kmeans_rdf(torch, mesh) -> dict:
    """15c: k-means and the forests on the mesh against their one-entry
    runs, on quality."""
    from oryx_tpu_torch.app.kmeans.common import assign_points
    from oryx_tpu_torch.app.kmeans.trainer import train_kmeans
    from oryx_tpu_torch.app.rdf.forest_arrays import ForestArrays
    from oryx_tpu_torch.app.rdf.trainer import train_forest
    from oryx_tpu_torch.parallel.kmeans_dist import train_kmeans_distributed
    out = {}
    pts = kmeans_points(MESH_KM_POINTS)
    # k-means|| spreads the initial centers over the true clusters: from
    # random rows, several share a cluster and the near-ties on their
    # borders amplify the two runs' different summation orders
    kw = dict(initialization="k-means||", seed=KM_SEED)
    t0 = time.perf_counter()
    one = train_kmeans(pts, KM_K, MESH_KM_ITERATIONS, device=DEVICE, **kw)
    t1 = time.perf_counter()
    dist = train_kmeans_distributed(pts, KM_K, MESH_KM_ITERATIONS, mesh,
                                    **kw)
    t2 = time.perf_counter()
    c1 = np.stack([c.center for c in one])
    c2 = np.stack([c.center for c in dist])
    cost = []
    dev_pts = torch.from_numpy(pts).to(DEVICE)
    for c in (c1, c2):
        _, dist_c = assign_points(dev_pts, c)
        cost.append(float(np.mean(dist_c.astype(np.float64) ** 2)))
    del dev_pts
    # each center's distance to the nearest of the other run's, both
    # ways (tests/test_parallel.py's agreement test): the two runs sum in
    # other orders, points on a border between two centers of one true
    # cluster flip, and each flip moves a center, so the centers agree to
    # MESH_KM_CENTER_TOL and the quality (the cost) much closer
    ds = np.linalg.norm(c1[:, None, :] - c2[None, :, :], axis=2)
    moved = float(max(ds.min(axis=0).max(), ds.min(axis=1).max()))
    check(moved <= MESH_KM_CENTER_TOL,
          f"mesh kmeans: centers {moved} from one entry's")
    check(abs(cost[1] - cost[0]) <= MESH_KM_COST_RTOL * cost[0],
          f"mesh kmeans: cost {cost[1]} against {cost[0]}")
    out["kmeans"] = {"points": len(pts), "k": KM_K, "one_s": t1 - t0,
                     "mesh_s": t2 - t1, "max_center_diff": moved,
                     "mean_sq_dist": cost}
    free()
    x, y, x_test, y_test, _ = rdf_bench_data(MESH_RDF_EXAMPLES, RDF_SEED,
                                             False)
    schema = rdf_schema(False)
    args = (schema, {}, MESH_RDF_TREES, MESH_RDF_DEPTH, RDF_BINS, "gini")
    t0 = time.perf_counter()
    one = train_forest(x, y, *args, seed=RDF_SEED, num_classes=2,
                       device=DEVICE)
    t1 = time.perf_counter()
    dist = train_forest(x, y, *args, seed=RDF_SEED, num_classes=2,
                        mesh=mesh)
    t2 = time.perf_counter()
    full = np.full((len(x_test), schema.num_features), np.nan, np.float32)
    full[:, :RDF_PREDICTORS] = x_test
    p1 = ForestArrays(one, schema.num_features, 2,
                      device=DEVICE).predict_proba(full)
    p2 = ForestArrays(dist, schema.num_features, 2,
                      device=DEVICE).predict_proba(full)
    check(np.array_equal(one.feature_importances, dist.feature_importances)
          and np.array_equal(p1, p2),
          "mesh rdf: the classification forest differs from one entry's")
    accuracy = float((p2.argmax(1) == y_test).mean())
    check(accuracy >= RDF_MIN_ACCURACY, f"mesh rdf: accuracy {accuracy}")
    out["rdf"] = {"examples": len(x), "depth": MESH_RDF_DEPTH,
                  "one_s": t1 - t0, "mesh_s": t2 - t1, "accuracy": accuracy}
    xr, yr, xr_test, yr_test, _ = rdf_bench_data(RDF_REG_EXAMPLES,
                                                 RDF_SEED + 2, True)
    full = np.full((len(xr_test), RDF_PREDICTORS + 1), np.nan, np.float32)
    full[:, :RDF_PREDICTORS] = xr_test
    rmse = []
    for m in (None, mesh):
        reg = train_forest(xr, yr, rdf_schema(True), {}, MESH_RDF_TREES,
                           MESH_RDF_DEPTH, RDF_BINS, "variance",
                           seed=RDF_SEED + 2, device=DEVICE, mesh=m)
        pred = ForestArrays(reg, RDF_PREDICTORS + 1, 0,
                            device=DEVICE).predict_value(full)
        rmse.append(float(np.sqrt(np.mean((pred - yr_test) ** 2))))
    check(rmse[1] <= 1.05 * rmse[0] and rmse[1] < 0.5 * float(yr_test.std()),
          f"mesh rdf: regression RMSE {rmse[1]} against {rmse[0]}")
    out["rdf"]["regression_rmse"] = rmse
    return out


def mesh_nccl(torch) -> dict:
    """15d: a one-process NCCL group joined through
    ``initialize_multihost``; one all_reduce through the mesh's
    cross-process sum."""
    import torch.distributed as dist
    from oryx_tpu_torch.common.config import from_dict
    from oryx_tpu_torch.parallel.mesh import Mesh, initialize_multihost, psum
    addr = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    joined = initialize_multihost(from_dict({
        "oryx.distributed.coordinator-address": addr,
        "oryx.distributed.num-processes": 1,
        "oryx.distributed.process-id": 0}), device=DEVICE)
    try:
        check(joined and dist.is_initialized(), "mesh: the group did not "
              "join")
        backend = dist.get_backend()
        mesh = Mesh([torch.device(DEVICE, 0) if DEVICE == "cuda"
                     else DEVICE], group=dist.group.WORLD)
        total = psum(mesh, [torch.arange(4, dtype=torch.float32,
                                         device=mesh.devices[0])])[0]
        check(total.cpu().tolist() == [0.0, 1.0, 2.0, 3.0],
              f"mesh: all_reduce gave {total}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return {"backend": backend, "address": addr,
            "s": time.perf_counter() - t0}


def mesh_phase(torch, keep: dict, work_dir: str) -> dict:
    """Phase 15: sharded serving, distributed ALS, k-means and the
    forests on a mesh of two entries of the one card, and a one-process
    NCCL join; the ``mesh`` line."""
    t_phase = time.perf_counter()
    single, twin, load_s = mesh_models(keep)
    gc.unfreeze()
    t0 = time.perf_counter()
    serving = mesh_serving(torch, single, twin)
    serving_s = time.perf_counter() - t0
    del single, twin
    free()
    mesh = mesh_of_one_card()
    t0 = time.perf_counter()
    als = mesh_als(torch, work_dir, mesh)
    als_s = time.perf_counter() - t0
    free()
    t0 = time.perf_counter()
    kr = mesh_kmeans_rdf(torch, mesh)
    kr_s = time.perf_counter() - t0
    free()
    nccl = mesh_nccl(torch)
    line = {"phase": "mesh", "entries": [str(d) for d in mesh.devices],
            "note": "two entries of one card: correctness and per-entry "
                    "overhead, not the speed of two cards",
            "serving": {"items": N_ITEMS, "features": FEATURES,
                        "dtype": "bfloat16", "users": MESH_USERS,
                        "twin_load_s": load_s, "s": serving_s,
                        "windows": serving},
            "als": {**als, "s": als_s}, "kmeans": kr["kmeans"],
            "rdf": kr["rdf"], "kmeans_rdf_s": kr_s, "nccl": nccl,
            "seconds": time.perf_counter() - t_phase}
    log(line)
    return line


class StderrWatch:
    """This process's standard error (fd 2, which the processes it starts
    inherit) passed through a pipe and searched for ``needle``."""

    def __init__(self, needle: str):
        self.needle = needle.encode()
        self.hits = 0
        self._saved = os.dup(2)
        read, write = os.pipe()
        os.dup2(write, 2)
        os.close(write)
        self._read = read
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="stderr-watch")
        self._thread.start()

    def _pump(self) -> None:
        # never stops draining while a writer lives: a full pipe would
        # stop every process that writes to it
        tail = b""
        while True:
            try:
                chunk = os.read(self._read, 1 << 16)
            except OSError:
                return
            if not chunk:
                return
            view = memoryview(chunk)
            while view:
                try:
                    view = view[os.write(self._saved, view):]
                except OSError:
                    break
            text = tail + chunk
            self.hits += text.count(self.needle) - tail.count(self.needle)
            tail = text[-len(self.needle):]

    def close(self) -> int:
        """Restore fd 2; the hits so far (what the processes still
        holding the pipe write later passes through unsearched)."""
        sys.stderr.flush()
        os.dup2(self._saved, 2)
        self._thread.join(5.0)
        return self.hits


def known_items(rng, n_items: int) -> dict:
    return {f"u{u}": [f"i{j}" for j in rng.integers(0, n_items,
                                                    KNOWN_PER_USER)]
            for u in range(N_USERS)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--trace", metavar="DIR",
        help="after phase 4's timed fold-in round, run it once more under "
             "torch.profiler and write its operator tables and Chrome trace "
             "under DIR")
    parser.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated phases to run, of " + ", ".join(PHASES)
             + " (default: all)")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        parser.error(f"unknown phases {sorted(phases - set(PHASES))}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from oryx_tpu_torch.common import compile_cache
    from oryx_tpu_torch.common.config import from_dict
    from oryx_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    # the layers this process starts inherit the first cache directory:
    # their libraries stay in build/kernels, where this phase builds them
    compile_cache.enable_from_config(from_dict(
        {"oryx.compile-cache-dir": str(cuda_build.BUILD_DIR.parent)}))
    threading.excepthook = thread_failed
    global STDERR_WATCH
    STDERR_WATCH = StderrWatch(NO_CONTEXT)
    try:
        return run_all(torch, torch.cuda.get_device_name(0), t_start, args,
                       phases)
    finally:
        # fd 2 back before an exception's traceback is printed
        STDERR_WATCH.close()


def run_all(torch, gpu_name: str, t_start: float, args,
            phases: set) -> int:
    """Phases 1-15 and the summary lines."""
    from oryx_tpu_torch.ops import cuda_build
    # phase 1: environment and build
    log(gpu_line())
    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 must be False")
    mods = wrappers()
    # phase 3's first catalog, the run's first draw, is drawn while nvcc
    # builds (NumPy draws without the interpreter lock)
    rng = np.random.default_rng(SEED)
    first = background(rng.standard_normal, (N_ITEMS, FEATURES),
                       dtype=np.float32) if "serving" in phases else None
    t0 = time.perf_counter()
    cuda_build.build(sorted({m.SOURCE for m in mods.values()}))
    for mod in mods.values():
        if hasattr(mod, "build"):
            mod.build()
    log({"phase": "build", "kernels": sorted(mods),
         "build_s": time.perf_counter() - t0,
         "python": sys.version.split()[0], "torch": torch.__version__,
         "cuda": torch.version.cuda})
    for name, text in cuda_build.LOGS.items():
        print(f"--- {name}\n{text}", file=sys.stderr)

    # phase 4's model directory, phase 5's data and phase 6b's generation
    # are made by child processes while the earlier phases run
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    os.makedirs(os.path.join(work_dir, "model"))
    os.makedirs(os.path.join(work_dir, "ann_model"))
    spawn = multiprocessing.get_context("spawn")
    children = {}
    if phases & {"topic", "deploy", "obs"}:
        children["publisher"] = spawn.Process(
            target=publish_topic_model,
            args=(os.path.join(work_dir, "model"), TOPIC_SEED), daemon=True)
    if "lambda" in phases:
        children["preparer"] = spawn.Process(
            target=lambda_data, args=(work_dir,), daemon=True)
    if phases & {"cluster", "cluster_fast", "regions"}:
        os.makedirs(os.path.join(work_dir, "cluster_model"))
        children["cluster_publisher"] = spawn.Process(
            target=publish_cluster_model,
            args=(os.path.join(work_dir, "cluster_model"), CLUSTER_SEED),
            daemon=True)
    if "ann" in phases:
        children["ann_publisher"] = spawn.Process(
            target=publish_ann_generation,
            args=(os.path.join(work_dir, "ann_model"), ANN_TOPIC_SEED),
            daemon=True)
    for child in children.values():
        child.start()
    try:
        return run_phases(torch, gpu_name, t_start, children, work_dir,
                          args.trace, phases, rng, first)
    finally:
        for child in children.values():
            if child.is_alive():
                child.terminate()
            child.join(30)
        shutil.rmtree(work_dir, ignore_errors=True)


def run_phases(torch, gpu_name: str, t_start: float, children: dict,
               work_dir: str, trace_dir: str | None, phases: set, rng,
               first) -> int:
    """Phases 2-15; ``rng`` is the run's generator (``SEED``) and
    ``first`` the future of its first draw, phase 3's first catalog."""
    cases = []
    serves = {}
    entries = []
    # phase 3's 5M x 250 bfloat16 model, kept for phase 15
    keep: dict = {}
    if "serving" in phases:
        serving_phases(torch, rng, first.result(), gpu_name, cases, serves,
                       keep if "mesh" in phases else None)
    if "topic" in phases:
        # phase 4: the serving layer loads the 1M x 50 LSH model off the
        # update topic (BASELINE.md:37)
        serves["1M_50f_f32_lsh0.3_topic"] = serve_update_topic(
            children["publisher"], work_dir, rng, trace_dir)
    shards = catalog = None
    try:
        if "ann" in phases:
            # phase 6a's catalog is drawn while phase 5 runs
            catalog = ann_draw()
        if "lambda" in phases:
            lambda_phase(children["preparer"], work_dir)
            if "speed_shard" in phases:
                # phase 14's workers start now: their loads overlap the
                # phases between
                shards = start_speed_shards(work_dir)
        # phase 6: the IVF index at the protocol catalog, the k-means app at
        # the bench's shape and through its loop, then the index's load path
        # (last: its generation is the slowest child's work)
        if "ann" in phases:
            ann_at_scale(rng, catalog)
            catalog = None
            free()
        if "kmeans" in phases:
            kmeans_at_scale()
            free()
            kmeans_loop(work_dir)
            free()
        if "ann" in phases:
            ann_topic(children["ann_publisher"], work_dir)
            free()
        if "rdf" in phases:
            # phase 7: the random decision forest app, its trainer at the
            # bench's shape and its lambda loop
            rdf_at_scale()
            free()
            rdf_loop(work_dir)
            free()
        if "bench" in phases:
            # phase 8: the benches and the probe kernels
            entries += bench_phase()
            free()
        deploy = obs = obs_started = None
        cluster = fast = region = regions = None
        if "obs" in phases:
            # phase 10's layer starts now: its load overlaps phase 9
            obs_started = obs_start(children["publisher"], work_dir)
        try:
            if "deploy" in phases:
                # phase 9: the entry point, warmup and the kernel cache
                deploy = deploy_phase(children["publisher"], work_dir)
            if "cluster_fast" in phases:
                # phase 12's replicas start and load now, beside phase 10
                fast = start_fast_replicas(work_dir)
                send_fast_model_ref(fast, children["cluster_publisher"],
                                    work_dir)
            if obs_started is not None:
                # phase 10: the observability surface on phase 4's model
                started, obs_started = obs_started, None
                obs = obs_phase(started,
                                serves.get("1M_50f_f32_lsh0.3_topic"))
                free()
        except BaseException:
            if isinstance(fast, dict):
                stop_replicas(fast["pipes"], fast["procs"])
            raise
        finally:
            if obs_started is not None:
                obs_started["layer"].close()
        if "regions" in phases:
            # phase 13's region B too: it loads while phases 11-12 run
            region = start_region_b(work_dir)
        try:
            if "cluster" in phases:
                # phase 11: two replicas and the router on one card
                cluster = cluster_phase(children["cluster_publisher"],
                                        work_dir, fast, region)
                free()
            if fast is not None:
                # phase 12: the fast path on phase 11's model
                fast = cluster_fast_phase(children["cluster_publisher"],
                                          work_dir, fast, cluster)
                free()
            if region is not None:
                # phase 13: region B through the mirror, and the autoscaler
                regions = regions_phase(children["cluster_publisher"],
                                        work_dir, region, cluster)
                free()
        finally:
            if isinstance(fast, dict) and "pipes" in fast:
                stop_replicas(fast["pipes"], fast["procs"])
            if region is not None:
                stop_region_b(region)
        if "speed_shard" in phases:
            # phase 14: the sharded speed layer over the wire broker
            if shards is None:
                shard_generation(work_dir)
                shards = start_speed_shards(work_dir)
            speed_shard_phase(shards)
        stop_speed_shards(shards)
        shards = None
        if "mesh" in phases:
            # phase 15: several devices, two entries of the one card
            mesh_phase(torch, keep, work_dir)
            free()
    finally:
        stop_speed_shards(shards)
    if "serving" in phases:
        entries = product_entries(cases, serves) + entries
    if deploy is not None:
        # the float32 kernels' launches in the CLI-started serving process
        for entry in entries:
            if entry["name"] in deploy["launches"]:
                entry["deploy_launches"] = deploy["launches"][entry["name"]]
    if obs is not None:
        # the routed kernel's launches in phase 10's sampled round
        for entry in entries:
            if entry["name"] in obs["launches"]:
                entry["obs_launches"] = obs["launches"][entry["name"]]
    for key, run in (("cluster_launches", cluster),
                     ("cluster_fast_launches", fast)):
        if run is None:
            continue
        # each replica's launches of its routed kernel in the routed round
        for entry in entries:
            per = [r["launches"][entry["name"]] for r in run["replicas"]
                   if entry["name"] in r["launches"]]
            if any(per):
                entry[key] = per
    if regions is not None:
        # each region-B process's launches of its routed kernel: the
        # replicas' timed round, the autoscaled member's served requests
        for entry in entries:
            per = {r["process"]: r["launches"][entry["name"]]
                   for r in regions["replicas"]
                   if entry["name"] in r["launches"]}
            if any(per.values()):
                entry["regions_launches"] = per
    check(not THREAD_ERRORS, f"a thread failed: {THREAD_ERRORS}")
    hits = STDERR_WATCH.close() if STDERR_WATCH is not None else None
    check(not hits, f"{hits} lines say a thread ran CUDA work with "
          f"{NO_CONTEXT!r}")
    log({"phase": "total", "seconds": time.perf_counter() - t_start,
         "no_context_lines": hits,
         "phases": sorted(phases, key=PHASES.index)})
    log({"kernels": entries})
    log({"ok": True, "device": {"platform": "gpu", "kind": gpu_name,
                                "count": torch.cuda.device_count()}})
    return 0


def first_items() -> np.ndarray:
    """The 5M x 250 item vectors of phase 3's first configurations: the
    first draw of the run's generator (``SEED``), so phase 15 draws them
    again when phase 3 did not run."""
    return np.random.default_rng(SEED).standard_normal(
        (N_ITEMS, FEATURES), dtype=np.float32)


def serving_phases(torch, rng, Y: np.ndarray, gpu_name: str, cases: list,
                   serves: dict, keep: dict | None = None) -> None:
    """Phases 2-3: every configuration's kernel cases, route and served
    rounds, then the coverage cases.  ``Y`` is the run's first draw of
    ``rng`` (``first_items`` draws it again).  With ``keep``, the 5M x
    250 bfloat16 model stays there for phase 15."""
    # slice 1: 5M x 250 float32, bfloat16, and 1M x 250 LSH on "pallas";
    # 5M x 250 float32 with int8 selection forced on, on "i8"
    X = rng.standard_normal((N_USERS, FEATURES), dtype=np.float32)
    known = known_items(rng, N_ITEMS)
    model = build_model(FEATURES, Y, X, known, "float32")
    route = routed_config(model, "5M_f32_exact", "pallas")
    cases += float_cases(model, rng, gpu_name, False, [torch.float32])
    window_times(model, rng, "5M_f32_exact", route["chosen"])
    serves["5M_f32_exact"] = serve_and_check(
        model, "5M_f32_exact", route, 64, 8, 8, RTOL["float32"], 8)
    vecs, active = model.Y.device_arrays()
    cases += i8_cases(vecs, active, rng, gpu_name, FEATURES, WINDOWS)
    del vecs, active
    free()
    model, serves["5M_250f_f32_int8"] = serve_config(
        FEATURES, Y, X, known, "5M_250f_f32_int8", "i8", "float32", 1.0,
        "true", (32, 4, 4), rng, model=model)
    del model
    free()
    model = build_model(FEATURES, Y, X, known, "bfloat16")
    route = routed_config(model, "5M_bf16_exact", "pallas")
    cases += float_cases(model, rng, gpu_name, False, [torch.bfloat16])
    window_times(model, rng, "5M_bf16_exact", route["chosen"])
    serves["5M_bf16_exact"] = serve_and_check(
        model, "5M_bf16_exact", route, 32, 4, 4, RTOL["bfloat16"], 4)
    if keep is not None:
        keep["5M_bf16_exact"] = model
    del model
    free()
    if keep is not None:
        # the kept model's 5M-entry id list and set would otherwise be
        # traversed by every full garbage collection until phase 15,
        # slowing each later in-process load by about half
        gc.freeze()
    known_lsh = {u: [f"i{int(i[1:]) % N_LSH_ITEMS}" for i in items]
                 for u, items in known.items()}
    model = build_model(FEATURES, Y[:N_LSH_ITEMS], X, known_lsh, "float32",
                        sample_rate=LSH_RATE)
    route = routed_config(model, "1M_f32_lsh0.3", "pallas")
    cases += float_cases(model, rng, gpu_name, True,
                         [torch.float32, torch.bfloat16])
    window_times(model, rng, "1M_f32_lsh0.3", route["chosen"])
    serves["1M_f32_lsh0.3"] = serve_and_check(
        model, "1M_f32_lsh0.3", route, 32, 4, 4, RTOL["float32"], 4)
    del model, Y
    free()

    # 50 features (BASELINE.md:37, :50): "i8" by default
    Y = rng.standard_normal((N_ITEMS, 50), dtype=np.float32)
    X = rng.standard_normal((N_USERS, 50), dtype=np.float32)
    model, serves["5M_50f_f32_auto"] = serve_config(
        50, Y, X, known, "5M_50f_f32_auto", "i8", "float32", 1.0, "auto",
        (32, 4, 4), rng)
    vecs, active = model.Y.device_arrays()
    cases += i8_cases(vecs, active, rng, gpu_name, 50, (8, 256))
    del model, vecs, active
    free()
    model, serves["1M_50f_f32_lsh0.3"] = serve_config(
        50, Y[:N_LSH_ITEMS], X, known_lsh, "1M_50f_f32_lsh0.3", "i8",
        "float32", LSH_RATE, "auto", (32, 4, 4), rng)
    del model, Y
    free()

    # 10 features (reference.conf:741): "i8_fold" by default, "fold"
    # with int8 selection off
    Y = rng.standard_normal((N_FOLD_ITEMS, 10), dtype=np.float32)
    X = rng.standard_normal((N_USERS, 10), dtype=np.float32)
    known_20m = known_items(rng, N_FOLD_ITEMS)
    y_ids = [f"i{j}" for j in range(N_FOLD_ITEMS)]
    model, serves["20M_10f_f32_auto"] = serve_config(
        10, Y, X, known_20m, "20M_10f_f32_auto", "i8_fold", "float32", 1.0,
        "auto", (32, 4, 4), rng, y_ids, anonymous=True)
    vecs, active = model.Y.device_arrays()
    cases += fold_cases(vecs, active, rng, gpu_name, 10, WINDOWS, "20M_10f",
                        float_windows=(8, 256))
    del vecs, active
    free()
    model, serves["20M_10f_f32_noint8"] = serve_config(
        10, Y, X, known_20m, "20M_10f_f32_noint8", "fold", "float32", 1.0,
        "false", (32, 4, 4), rng, y_ids, model=model)
    del model, Y, y_ids
    free()

    # coverage, not a configuration: phase_a at narrow widths and a
    # window above 256 queries; fold 4 runs the folded 8-column path, and
    # the folded int8 kernel a window of two query tiles at fold 2
    cases += coverage_cases(rng, gpu_name)
    cases += i8_coverage_cases(rng, gpu_name)
    all_live = torch.ones(COVERAGE_ROWS, dtype=torch.bool, device=DEVICE)
    for features, windows, float_windows in (
            (COVERAGE_FEATURES, COVERAGE_WINDOWS, (8,)),
            (10, (WIDE_WINDOW, MIXED_WINDOW), ())):
        vecs = torch.zeros((COVERAGE_ROWS, 32), device=DEVICE)
        vecs[:, :features] = torch.from_numpy(rng.standard_normal(
            (COVERAGE_ROWS, features), dtype=np.float32)).to(DEVICE)
        cases += fold_cases(vecs, all_live, rng, gpu_name, features, windows,
                            "coverage", float_windows)
        del vecs
        free()


def lambda_phase(preparer, work_dir: str) -> None:
    """Phase 5: ALS training at MovieLens-20M's shape, then the lambda
    loop through the port's batch, speed and serving layers."""
    from oryx_tpu_torch.common.config import get_default
    defaults = get_default()
    t_wait = time.perf_counter()
    preparer.join(LOOP_WAIT_S)
    check(preparer.exitcode == 0,
          f"phase 5: preparing the data failed ({preparer.exitcode})")
    log({"phase": "lambda_data", "waited_s": time.perf_counter() - t_wait})
    train_at_scale(work_dir,
                   defaults.get_double("oryx.als.hyperparams.lambda"),
                   defaults.get_double("oryx.als.hyperparams.alpha"))
    free()
    lambda_loop(work_dir, loop_config(work_dir).get_double(
        "oryx.als.hyperparams.lambda"))
    free()


def product_entries(cases: list, serves: dict) -> list[dict]:
    """The ``kernels`` entries of the product kernels: each one's head
    case and the timed round of the first configuration whose route chose
    it; a kernel that served no timed round fails the run."""
    def head(kernel, **want):
        return next(c for c in cases if c["kernel"] == kernel
                    and not c["lsh"] and c["B"] == 256
                    and c.get("label") != "coverage"
                    and all(c[k] == v for k, v in want.items()))

    # summary entry: (wrapper, head case, the configurations that may
    # serve it, head configuration first, the cases whose largest error
    # it reports)
    f32_configs = [c for c in serves if c != "5M_bf16_exact"]
    heads = {
        "phase_a": ("phase_a", head("phase_a", store="float32"),
                    f32_configs, {"store": "float32"}),
        "phase_a_bf16": ("phase_a", head("phase_a", store="bfloat16"),
                         ["5M_bf16_exact"], {"store": "bfloat16"}),
        "phase_a_i8": ("phase_a_i8", head("phase_a_i8", features=50),
                       ["5M_50f_f32_auto", *f32_configs], {}),
        "phase_a_fold": ("phase_a_fold", head("phase_a_fold",
                                              store="float32"),
                         ["20M_10f_f32_noint8", *f32_configs], {}),
        "phase_a_i8_fold": ("phase_a_i8_fold", head("phase_a_i8_fold"),
                            ["20M_10f_f32_auto", *f32_configs], {})}
    # each kernel's served configuration is the first of its list whose
    # route chose it, so its timed round launched it (a route may leave
    # the static order); the route measurement's launches stand apart
    served = {name: next((c for c in dict.fromkeys(configs)
                          if serves[c]["launches"][wrapper] > 0), None)
              for name, (wrapper, _, configs, _) in heads.items()}
    check(None not in served.values(),
          f"a kernel served no configuration's timed round: {served}")
    return [{
        "name": name, "route": "cuda", "source": KERNELS[wrapper][1],
        "replaces": KERNELS[wrapper][0],
        "launches": serves[served[name]]["launches"][wrapper],
        "route_launches": serves[served[name]]["route_launches"][wrapper],
        "max_abs_err": max(c["max_abs_err"] for c in cases
                           if c["kernel"] == wrapper
                           and all(c[k] == v for k, v in of.items())),
        "ms": h["ms"], "plain_ms": h["plain_ms"],
        "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
        "library_ms": h["library_ms"], "served_config": served[name],
        **({"body": h["body"]} if "body" in h else {}),
        "shape": {"rows": h["rows"], "width": h["width"],
                  "features": h["features"], "B": h["B"],
                  "store": h["store"]}}
        for name, (wrapper, h, _, of) in heads.items()]


if __name__ == "__main__":
    sys.exit(main())
