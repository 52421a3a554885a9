#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hercules_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit.  Phases, each printing one
JSON line {"phase": ...}:

1. build   -- compile hercules_tpu_torch/csrc/*.cu with nvcc; the
              registers of the tiled kernels (K1 and K5 by type, K2,
              K3, K4 and K6 by type, memory-variable type and kappa)
              from the ptxas -v log; K4's launch grid (resident
              blocks, slab depth, work items) on the 2048-element and
              the 2^20-element box, by type and kappa, from the library
              (ht_bkt_corner_grid_*), its slab and work items equal to
              kernels/tiles.py's corner_grid for those resident blocks.
   unstructured -- the unstructured solver (solver/step.py, torch ops,
              no kernel launched) through Simulation.run(solver=
              "unstructured"), 40 steps, on fixture (a) at 62.5 m, the
              graded box (GRADED_LAYERS, 264 dangling nodes) and the
              soft BKT box: float64 on the card within 1e-12 of max|u|
              (and of each memory-variable array's max) of the same run
              on the CPU, float32 stations within 1e-2 of float64's, a
              second float32 run bit-identical to the first.  On the
              2^20-element Rayleigh box in float32: its time loop per
              step through Simulation.run beside the cuda_chunk route's
              (K5) and the "bricks" route's (brickstep.run_brick_solver,
              torch ops: where "auto" sends an unknown damping name and
              conventional stiffness), in turns; its step back to back,
              alone, by device
              time (a CUDA graph of 20 steps), and the host's share of
              the step (1 - device / alone, as the mesh route's).
   loh1    -- LOH.1 (validation B2, tools/loh1.py, fixtures.loh1_case:
              the graded mesh of 5,632 elements, 7,179 nodes and 800
              dangling nodes, one brick and 1,536 loose elements), 200
              steps in float32 through Simulation.run, launch counters
              set to 0 just before each run and read just after: "auto"
              (route cuda_mesh, K1 launched once per step) and
              "unstructured" (no kernel); each run's stations scored
              against tests/goldens/loh1_fine_f64.npz (utils/gof.py),
              GOF >= 8 on every energetic component, at least 6; the
              cuda_mesh stations against the unstructured route's on the
              same inputs, within 1e-4 of their max in float32 and
              2e-13 in float64 (both routes run again in float64).
   nonlinear -- nonlinear soil at full width (item7_phases): the CLI
              on GRADED_Q_LAYERS at 3.90625 m (2,424,832 elements; the
              top 31.25 m, 524,288 elements, nonlinear: von Mises,
              rate-independent, Vs cut 700 m/s), 400 float32 steps, with
              and without geostatic loading: route cuda_mesh, K1 launched
              3 x 400 times, stations finite and non-zero, the stations
              in nonlinear elements with the 17 extra columns and
              plastic flow; "Solver", plan, tables and loop.  The step
              from the state after 200 steps (ep > 0 required), float32:
              back to back and alone, its device time by CUDA graph and
              the host's share, beside the same step without the subset
              pass (the same masked K1 tables), and the subset pass
              alone (its share of the step's device time).
   nonlinear_accuracy -- GRADED_Q_LAYERS at 62.5 m (40 steps) and at
              7.8125 m (303,104 elements, 65,536 nonlinear; 80 steps), with and
              without geostatic loading: float64 cuda_mesh against the
              unstructured route on the card within 5e-12 of max|u| and
              of each plastic state array; float32 stations within 1e-2
              of float64.  nonlinear_restart: 400 float32 steps with a
              checkpoint at 200 (geostatic: the captured bottom
              reactions ride it), resumed: states, samples and plastic
              state bit for bit on cuda_mesh.
   drm     -- GRADED_Q_LAYERS at 7.8125 m undamped, the shallow DRM box
              (fixtures.DRM_SHALLOW_BOX), 200 steps: part 1 on cuda_mesh
              with a source outside the box, part 2 with zero source on
              cuda_mesh (and on the unstructured route in float64); in
              float64 part 2 reproduces part 1's field inside the box
              within 1e-9 of its max and leaves at most 1e-9 outside,
              cuda_mesh within 5e-12 of unstructured; in float32 within
              1e-3.
   buildings -- fixture (a) with the building of the JAX building
              tests, carved (route cuda_mesh, one brick and loose
              elements) and fixed-base (the unstructured route, the
              reason recorded), 40 float64 steps: card against CPU
              within 1e-12, the base nodes equal to the prescribed
              series at the last step.
   multigpu -- the multi-chip paths (hercules_tpu_torch/parallel/,
              ROADMAP Queue 1, item 8a) through Simulation.run(devices=
              [cuda:0] * P), every rank on the one card: fixture (a) at
              7.8125 m (2^20 elements), 400 steps, slab_pallas (a step
              kernel per z-slab fragment) with Rayleigh damping at P = 2,
              3, 4 (K1), BKT with one Q set at P = 4 (K2) and the
              thin-layer box at P = 4 (K4), float32 and float64, each
              kernel launched P x 400 times and nothing else; float64
              stations within 1e-9 of the single-device route's, float32
              within 1e-2 of float64 (and of the single-device float32
              route's); the plain slab step (mc_path "slab", torch ops)
              on the card against the kernels' path in float64 (2e-13);
              the 62.5 m boxes on 8 ranks (one-layer fragments: the tile
              marches' smallest brick) with K1, K2 and K4, 40 steps, the
              same bounds; the fragments' step kernels against their
              plain versions from random states (rank 0 and the last
              rank, 5 steps: 2e-13 in float64, 1e-4 in float32, 5e-3 on
              bfloat16 memory variables); "sharded" on the 2^20 box (400
              steps) and on GRADED_LAYERS at 3.90625 m (2,424,832
              elements, 200 steps) at P = 4 against the unstructured
              route in float64 (1e-9), float32 within 1e-2; both copies
              of every shared plane and node bit-identical after every
              run; a step-200 checkpoint of 400 steps (BKT, float32)
              resumed bit for bit on slab_pallas and on sharded, P = 4;
              the slab step at 2^20 in float32 at P = 1, 2, 4 on the one
              card (back to back, alone, by CUDA graph, the kernels'
              device time and bound, the host's share), and the
              communication model's predictions for 2, 4 and 8 cards
              from the one-card K1 rate (comm_model.predict, labelled a
              prediction).
   multigpu_graded -- the graded multi-chip paths (parallel/gslab.py,
              parallel/gmesh.py, ROADMAP Queue 1, item 8b) through
              Simulation.run(devices=[cuda:0] * P), 200 steps each:
              gslab (the automatic choice) on GRADED_LAYERS at 3.90625 m
              (2,424,832 elements, three bricks) with Rayleigh at P = 2
              and 4 in both types (K1), with BKT at P = 4 (K2) and on
              GRADED_Q_LAYERS (a brick of four Q sets: K4 on every
              brick); gmesh (the automatic choice: gslab refuses the
              vertical interface) on the basin case
              (fixtures.write_basin_case, 2,883,584 elements) with
              Rayleigh (K1) and BKT (K2) at P = 2 and 4 in both types;
              each kernel launched bricks x P x 200 times and nothing
              else; float64 stations within 1e-9 of the single-device
              cuda_mesh route's, float32 within 1e-2 of float64; every
              brick's fragment kernels against their plain versions
              from random states (ranks 0 and P - 1, 5 steps:
              2e-13 in float64, 1e-4 in float32, 5e-3 on bfloat16
              memory variables); replicas bit-identical after every
              run; a step-100 checkpoint resumed bit for bit on gslab
              (BKT, P = 4) and on gmesh with nonlinear soil
              (GRADED_Q_LAYERS at 3.90625 m, 524,288 nonlinear
              elements, float32, P = 2, ep > 0 at the end); the gslab
              and gmesh steps in float32 at P = 2 and 4 beside the
              cuda_mesh step on the same box (back to back, alone, by
              CUDA graph, the kernels' device time and bound, the host's
              share); comm_model's predictions and plan_scaling_report
              for 2, 4 and 8 cards (labelled predictions).
   multiprocess -- the multi-process launcher (parallel/multihost.py,
              ROADMAP Queue 1, item 8c) as 2 processes on the one card
              over gloo (multihost.spawn; each child given 300 s, any
              child's failure fails the phase): the O(shard) slab
              pipeline on fixture (a) at 2^20 (each process meshes and
              tabulates only its block), Rayleigh 400 steps (K1) and one
              Q set 200 steps (K2) in both types, each child's counter
              reading steps x local ranks and nothing else, float32
              within 1e-2 of float64; the 62.5 m boxes (K1, K2, K4), 40
              float64 steps, every state array bit-identical to the
              one-process run at P = 2 (main with two local ranks) and
              within 2e-13 of max|u| of the plain slab step; the gather
              chain on GRADED_LAYERS (gslab) and the basin (gmesh) at
              7.8125 m, 100 float64 steps, bit-identical to the
              one-process path at P = 2; the 2-process step at 2^20 in
              float32 beside the one-process step (per step over the
              loop and after its first chunk, the exchanges' share), its
              bytes and phases per step equal to comm_model.slab_comm's,
              each process's meshing and tables seconds.  With 2 or
              more cards, nccl_check: the 62.5 m boxes over NCCL, a card
              per process, bit for bit; on one card a line says NCCL
              was not run.
   tools   -- the port's tools and graft_entry (ROADMAP Queue 1,
              items 9a-9c; tools_phase): tools/resident_bench on
              fixture (a) at 2^20 in float32, 400 steps per K5 launch
              (one to warm, two timed), its lines, its 3 K5 launches,
              its state bit-identical to run_pallas_solver's chunk
              route from the same seeded start; tools/perf_ab
              rayleigh 100 and bkt 100 with the configs "" and
              HT_BKT_UNIFORM=0 on the same box (built once for both
              tools; the BKT box once more), 2 x 2 x (100 + 100) K1 or
              K2 launches, one route and tier for both configs;
              graft_entry.entry: a float32 step on the card, float64
              over three steps within 1e-12 of max|u| of the CPU's;
              graft_entry.dryrun_multichip(4), every rank on the card:
              each leg's line and launches (K1 on legs 1-3 and 6, K2
              on leg 4); utils/debug: make_chunk_checker as on_chunk
              of a 62.5 m run, and a NaN at node k named k in the
              route's layout and in the global [N, 3] field.
2. k1      -- brick_step (K1) against brick_step_plain on the card: the
              2048-element box and the four-layer Rayleigh box at
              62.5 m (one brick, 2048 elements with four different c1,
              c2 and beta: a tile reading another element's
              coefficients fails here), 40 steps in float64 (bound
              2e-13 max|u|) and 20 in float32 (1e-4 max|u|) each; the
              2^20-element box, 10 steps in float32 (1e-4 max|u|).  On
              the seeded bricks (SEEDED_BRICKS: B1, the graded fine
              brick, two node planes, rows of 49 nodes), both types:
              the library's grid (stages, blocks per SM, resident
              blocks, slab, items, tile width: 44 in float32 on B1
              and two planes, else 32) equal to kernels/tiles.py's
              step_grid, one step of the layout S whose u+ has the
              synchronous march's bytes
              (K1_LEAN_DIGESTS), whose rows 3:6 are its input's u and
              whose rows 6:8 are zero (the seeded rows 6:8 are not),
              and brick_step.configs counting the B1 launch under its
              key; K1's lean form against its canonical form (k1_forms:
              u+ byte for byte, K1_LEAN_DIGESTS, the rows the lean form
              must not write left alone), both forms timed at 2^21
              in both types with the rows each moves, and the lean
              form on rows49 (32-wide tiles in float32 too).
3. k5      -- brick_chunk (K5) against the K1 step loop on the
              2048-element box and the four-layer Rayleigh box, chunks
              of 16 steps, 37 steps, float64 and float32: states
              bit-identical, samples within 1e-12 (float64) / 1e-5
              (float32) relative; K5 against brick_chunk_plain at
              2^20 elements, 10 steps in float32 (1e-4 max|u|); and K5
              against the K1 loop on the seeded bricks, 9 steps with 4
              sources and 6 stations, both types: u and u- bit for bit,
              K5's rows 6:8 the seeded ones it carries, K1's zeros.
   source_sample -- SourceSample (csrc/source_sample.cu) at B1's
              shapes (b1_source_sample: the seeded B1 brick, the point
              source's 8 nodes, 256 stations), float32 and float64, 4
              steps: the add bit for bit the card's and the CPU's
              index_add_, the samples within 4e-6 (float32) / 1e-14
              (float64) of max|sample| of the float64 einsum (two
              corners swapped miss that by 100 times), each half alone,
              sources sharing nodes as the CPU's index_add_, one launch
              counted per call (source_sample_phase).
4. main    -- the elastic main path through the CLI, launch counters
              set to 0 just before and read just after: the
              2^20-element box (128 x 128 x 64 at 7.8125 m), 400 steps,
              a point source and 5 stations, in float32 (route
              cuda_chunk) and in float64 (cuda_step).  Stations finite
              and non-zero, float32 within 1e-2 of float64, both
              kernels launched.
5. accuracy -- 131,072 elements (15.625 m), 200 steps: the float32
              CUDA run's stations within 1e-2 relative of the float64
              plain versions run on the card.
6. k2      -- bkt_step (K2) against bkt_step_plain on the card, from
              random S and memory variables, with the sources: the BKT
              box (shear attenuation only), 40 steps in float64 (S and
              conv within 2e-13 of their max) and 20 in float32 (1e-4);
              the soft box (bulk attenuation on), float64 (2e-13) and
              float32 with bfloat16 conv (1e-3); the 2^20-element BKT
              box, 5 steps in float64 (2e-13) and 10 in float32 (1e-4).
              Padding stays zero.
7. k6      -- bkt_chunk (K6) against the K2 step loop on the BKT box
              and the soft box, chunks of 16, 37 steps, float64 and
              float32: S and conv bit-identical, samples within 1e-12
              / 1e-5 relative; K6 against bkt_chunk_plain at 2^20
              elements, 10 steps in float32, on the BKT box (1e-4) and
              on the soft box (12 rows of bfloat16 memory variables,
              phase outputs' K6 case: 1e-4 on S and the samples, 5e-3
              on the memory variables); padding stays zero.
8. main_bkt -- phase 4 with type_of_damping = bkt: routes
              cuda_bkt_chunk (float32) and cuda_bkt_step (float64),
              both BKT kernels launched.
9. accuracy_bkt -- phase 5 on the BKT box: float32 CUDA stations
              within 1e-2 relative of bkt_chunk_plain in float64.
10. k3     -- the node-tier step route (bkt_node_step, K3, the mixed
              elements' force formed inside, then the sources) against
              the same route on bkt_node_step_plain (the direct form),
              from random S, memory variables and mixed-element state:
              the two-layer box (two Q sets), 40 steps in float64 (S,
              conv and conv_mix within 2e-13 of their max) and 20 in
              float32 with bfloat16 memory variables (1e-3); its
              shear-only variant in float32 (1e-4); the four-layer box
              at 2^20 elements (four Q sets, 49,533 mixed elements) in
              both types of its main path: 5 steps in float64 (2e-13 on
              S, conv and conv_mix) and 10 in float32 (1e-4 on S, 5e-3
              on the memory variables).  Padding stays zero.
11. k4     -- bkt_corner_step (K4, one launch per step on the BKT tile
              march) against bkt_corner_step_plain: the four-layer box
              at 62.5 m (where the rule picks the corner tier), 40
              steps in float64 (2e-13) and 20 in float32 (1e-3); the
              two-layer box forced to the corner tier, float64
              (2e-13); the four-layer box at 2^20 forced to the corner
              tier, 10 steps in float32 (1e-4 on S, 5e-3 on the memory
              variables); the thin-layer box (THIN_Q_LAYERS, 48 % of
              its elements mixed: the corner tier by the rule) at 2^20,
              10 steps in float32 (1e-4 on S, 5e-3 on the memory
              variables) and 5 in float64 (2e-13).
12. main_bktq -- phase 4 on the four-layer box at 2^20 elements: both
              types on the node tier (route cuda_bkt_node_step), K3
              launched once per step (800 over both types) and nothing
              else run for the mixed elements.  main_bktq_corner: the
              corner tier's main path through the CLI, the four-layer
              box at 62.5 m (2048 elements) and the thin-layer box at
              2^20 elements, 400 steps each in both types, no tier
              forced: route cuda_bkt_corner_step, K4 launched once per
              step (400 per type on each box).
13. accuracy_bktq -- the four-layer box at 15.625 m (131,072 elements),
              200 steps: the float32 CUDA stations within 1e-2 relative
              of the node route on the plain versions in float64.
14. k_mesh -- K1, K2, K3 and K4 (each brick's step module, as the
              mesh route builds it, or forced to the node and the
              corner tier) against their plain versions from random
              states on every brick of the graded plans: the 62.5 m
              GRADED_LAYERS plan (bricks of 867, 162 and 50 nodes) with
              Rayleigh damping and BKT, and its GRADED_Q_LAYERS variant
              (the corner tier by the rule, mixed elements; forced to the
              node tier); the 3.90625 m GRADED_LAYERS plan (2,424,832
              elements, three bricks with the reordered storage axes
              (1, 2, 0)), K3 and K4 forced on its fine brick; every
              brick of the plans main_mesh_small drives, on the tier the
              rule gives it: GRADED_Q_LAYERS and GRADED_THIN_LAYERS at
              7.8125 m (their fine brick, 282,897 nodes with mixed
              elements, on K3 and on K4), the TeraShake copy's brick
              (K1) and the LOH.1 brick phase loh1 runs (K1); 40 steps in float64 (S and the memory variables
              within 2e-13 of their max) and 20 in float32 (1e-4; 1e-3
              on bfloat16 memory variables, 5e-3 on those of
              main_mesh_small's bricks, as phases k3 and k4 hold K3 and
              K4 on mixed bricks).  Padding stays zero.
15. main_mesh -- the graded main path through the CLI: GRADED_LAYERS at
              3.90625 m, 400 steps, 5 stations, with Rayleigh damping
              and with BKT, float32 and float64 (route cuda_mesh; every
              launch counter set to 0 just before each run and read just
              after, each kernel launched bricks-on-its-tier x steps
              times; stations finite and non-zero, float32 within 1e-2
              of float64).  main_mesh_small: Simulation.run in both
              types on GRADED_Q_LAYERS and GRADED_THIN_LAYERS at 7.8125 m
              (the node tier, K3, and the corner tier, K4, on their fine
              bricks) and on the TeraShake copy (one brick and 9,216
              loose elements, 200 steps): route cuda_mesh, the same
              launch counts, float32 within 1e-2 of float64.
    outputs -- output taps, checkpoints and restart through the CLI,
              on the 2^20-element box with Rayleigh damping in float32
              (cuda_chunk, K5), the soft box (uniform BKT, bulk
              attenuation on: bfloat16 memory variables) in float32
              (cuda_bkt_chunk, K6), the four-layer box in float32
              (cuda_bkt_node_step, K3, mixed elements), the thin-layer
              box in float64 (cuda_bkt_corner_step, K4) and
              GRADED_Q_LAYERS at 7.8125 m in float32 (cuda_mesh, K2 and
              K3): run A 400 steps with 4-D displacement and velocity
              every 40 steps, one plane every 20, checkpoints every
              200; run B from A's step-200 checkpoint as checkpoint.in.
              Held: B's station rows are A's from step 200 on, its 4-D
              frames after step 200 A's, its step-400 checkpoint A's,
              bit for bit; A's last frames (step 360) the state of
              Simulation.run(total_steps=360), bit for bit after
              widening (velocity (u - u-)/dt); each plane record at a
              frame's step the phi-weighted corner sum of the frame
              (1e-12 relative); the launches of A and B (a chunk kernel
              once per 20 steps, a step kernel once per step and
              brick, on the single-brick step route SourceSample once
              a step and once more per 20 steps).  Printed: "Solver", the time loop and the taps'
              host seconds with the taps on, the straight run's loop
              and phase main's runs without them, the 4-D writer's
              io_seconds; a tap's pieces on the host's clock (the node
              index's copy to the card, made once per run; a global
              field, scatter and copy to the host; that copy alone; a
              plane-only record's corner gather, held equal to the
              global field at those nodes).
16. accuracy_mesh -- on the 3.90625 m plan in float64, from a random
              state, 40 steps with the source: the mesh route (plane
              reconciler, and the index epilogue) against the port's
              plain brick solver (brickstep.run_brick_solver) on the
              card, within 5e-12 of max|u| and of the largest sample,
              the two reconcilers within 5e-12 of each other, each run
              repeated bit for bit; Rayleigh and BKT.
17. k7     -- stream_add (K7), out of place and aliased (out is a),
              against stream_add_plain on the probe's [8, 33 x 32768]
              float32 arrays: bit-identical.
18. hbm_ceiling -- K7's main path, the probe's entry point
              (hercules_tpu_torch.tools.hbm_ceiling.main), launch
              counter set to 0 just before and read just after: the
              four legs in turns (torch.add, stream_add, stream_add
              aliased, torch.add again), ms per iteration and GB/s
              beside the card's name and power limit.
19. timing -- CUDA events, medians of >= 20 calls after warm-up, each
              kernel at the shape and type of its main path's launches:
              at 2^20 elements K1 and K2 in float64 (their step routes'
              type) against their plain versions, K5 and K6 in float32
              per step over one launch of the main path's 400 steps
              against brick_chunk_plain and bkt_chunk_plain, K3 in
              float32 and float64 on the four-layer box (bfloat16 /
              float64 memory variables, 49,533 mixed elements) against
              bkt_node_step_plain; K4 on both boxes of its main path
              (the four-layer box at 62.5 m and the thin-layer box at
              2^20) in float32 and float64, and the four-layer box
              forced at 2^20 in float32 for comparison (K4's kernel
              table row is the thin-layer box in float32); K1 and K2 in
              float32 and K2/K6 on the soft box
              (bfloat16 memory variables, bulk attenuation on) beside
              them; K1 and K2 at the fine brick of the 3.90625 m graded
              plan and K3 and K4 at the fine brick of main_mesh_small's
              Q variants (7.8125 m, the rule's tier), in both types; the
              mesh route's step at 3.90625 m (Rayleigh and BKT, both
              types, each reconciler in turns: plane, index, index,
              plane): back to back and alone, its launches per step,
              each brick's kernel by device time (a CUDA graph of its
              launches) and their sum, and the host's share of the
              step.  K7's time (aliased)
              and torch.add's are phase 18's legs.  Lone calls
              (synchronise, events around one call, median of 60): K7
              and torch.add on the probe's arrays, the
              K1, K2 and K3 route steps (the step kernel, then one
              SourceSample launch: the sources' add and the next step's
              samples) at 2^20 in float32, SourceSample at B1's shapes
              (b1_source_sample) in both types, and K4 on the
              2048-element box in both types; the host's microseconds
              per call of K7 and torch.add on [8, 1024] and of K4 on the
              2048-element box.  SourceSample at B1's shapes against
              the torch operations it replaced (source_sample_plain on
              the card), both types.
              For every kernel K1-K7 and SourceSample: its bound
              (utils/roofline.py:
              bytes and operations counted from the shapes of these
              inputs, against the H100's data sheet; the
              chunk kernels' bytes amortised over 400 steps only where
              their state fits the 50 MB L2, not at 2^20) and what
              sets it, the share of the bound its time reaches, its
              traffic's share of the measured aliased stream ceiling
              (phase 18), its launches on its main paths (the graded
              path's included; in the kernel table K1's also phase
              loh1's and the item-7 phases'), the time it loses there
              (launches x steps per launch x (time - bound), per type
              and timed shape), and the library call's time where one PyTorch
              call computes the same function (K7: torch.add); K5's
              step beside the K1 route step and K6's beside the K2
              route step (float32, back to back), the routing rule's
              times.

Then the kernel table as one JSON line, the card's name and power
limit (nvidia-smi), and last {"ok": true, "device": {...}}.  Any
failure raises (non-zero exit, no result line); so does a machine
without a CUDA device, and a run in which any module of jax or of the
JAX package hercules_tpu was loaded.  Plain versions run with TF32
matmuls disabled (torch.backends.cuda.matmul.allow_tf32 = False).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# per-phase JSON lines and the CLI runs' full output
LOG = os.path.join(ROOT, "build", "chip_smoke")


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(os.path.join(LOG, "phases.jsonl"), "a") as f:
        f.write(line + "\n")


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def tile_registers(log):
    """{kernel<T[,CT,kappa]>: registers} of the tiled kernels (K5:
    kernel<T>; K1: kernel<T,BX,BY,BA>, one a set of corner roles; K2,
    K3, K4, K6: kernel<T,CT,kappa>) from the ptxas -v output in the
    build log."""
    types = {"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}
    regs, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            bkt = re.search(r"(bkt_(?:step|chunk|node|corner)_kernel)I([fd])"
                            r"([fd]|13__nv_bfloat16)Lb([01])E", m.group(1))
            brick = re.search(r"(brick_(?:step|chunk)_kernel)I([fd])"
                              r"((?:Li\d+E)*)E", m.group(1))
            entry = None
            if bkt:
                k, t, ct, kappa = bkt.groups()
                entry = f"{k}<{types[t]},{types[ct]},{kappa}>"
            elif brick:
                k, t, roles = brick.groups()
                args = [types[t], *re.findall(r"\d+", roles)]
                entry = f"{k}<{','.join(args)}>"
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            regs[entry] = int(m.group(1))
            entry = None
    return regs


# Bricks the K1 and K5 phases step from seeded states: the node grid
# (outer, mid, inner) in storage order and the storage axis of x, y and
# z (corner index bits 0, 1, 2).
SEEDED_BRICKS = {
    # validation B1 at 1 Hz: 128^3 elements, LEN 2,147,328
    "b1": ((129, 129, 129), (2, 1, 0)),
    # the graded route's fine brick (GRADED_LAYERS at 3.90625 m): y the
    # planes, z the mid axis
    "graded_fine": ((257, 33, 257), (2, 0, 1)),
    # a fragment of one element layer: two node planes
    "two_planes": ((2, 40, 33), (2, 1, 0)),
    # rows of 49 nodes, which keep float32's tile 32 wide (tiles.py:
    # step_width), at 2,095,104 elements: y the inner axis, x the mid
    "rows49": ((342, 129, 49), (1, 2, 0)),
}
# sha256 of rows 0:3 (u+) of one K1 step from seeded_brick(..., seed=21)
# by the synchronous march (K1 before the staged pipeline; rows49's by
# the staged march on 32-wide tiles alone), by brick and type: K1's lean
# form writes these bytes alone, its canonical form in rows 0:3, on
# tiles of either width
K1_LEAN_DIGESTS = {
    "b1 float32":
        "8265683187a293d950ead90134631953b540f4d44f176cce6d756c2d13112f39",
    "b1 float64":
        "269bdfa2056650d2e76b209a073842aa82616b803672746e5c472930ab60168b",
    "graded_fine float32":
        "3de3836a24e2e6eb9dc6d1e9b863364214ef5c735c2975b7538697d3df44ec25",
    "graded_fine float64":
        "0d495146277c9f39f271d83c3f69421e576b8f01ab6e09ecfda2c5f432f16b32",
    "two_planes float32":
        "c8b0e0ba6965ef524eb8e83802e88d906fd282fce48150272c2fff0037a41d0e",
    "two_planes float64":
        "53cce297fbc42caf541f7904aa3acf947cf837458cb39a2407e242ab0e612a5d",
    "rows49 float32":
        "8ed1ac1ee97f2c36346b2d9ddb151d1de6e5dad950d0600548ef35a63092002b",
    "rows49 float64":
        "cff1c3088b227c5c5c25cf0be1754499ec8d78a57908ae02b10ffb05a5426fa6",
}

# rows of [LEN] values each form of K1 moves a step (csrc/brick_tile.cuh)
K1_FORM_ROWS = {"lean": 16, "canonical": 21}


def k1_forms(dev, reps=15, n=40):
    """K1's lean form against its canonical form on the seeded bricks
    (SEEDED_BRICKS, seed 21), both types: the lean form, from u and u-
    in tensors of their own, writes the canonical form's rows 0:3 (u+)
    byte for byte, their digest K1_LEAN_DIGESTS, and leaves a NaN in
    rows 3:8 of its out's buffer; the canonical form writes u in rows
    3:6 and zeros in rows 6:8.  Timed with CUDA events (the median over
    ``reps`` runs of ``n`` launches back to back, ms a launch), with the
    rows each moves, their rate and the tile width: both forms at B1's
    2^21 elements (44-wide tiles in float32), and the lean form on
    rows49's 2,095,104 (32-wide tiles in both types).  Returns
    {"digests", "timing"}."""
    import statistics
    import numpy as np
    import torch
    from hercules_tpu_torch.kernels.brick_step import (brick_step_lean,
                                                       step_grid_of)
    digest = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    digests, timing = {}, {}
    for name, (shape, axes) in SEEDED_BRICKS.items():
        for dtype in (torch.float32, torch.float64):
            key = f"{name} {str(dtype)[6:]}"
            S, K, offs = seeded_brick(shape, axes, dtype, 21, dev)
            U, Um = S[0:3].clone(), S[3:6].clone()
            lean = torch.full_like(S, float("nan"))
            brick_step_lean(U, Um, K, offs, None, lean[0:3])
            canon = torch.full_like(S, float("nan"))
            brick_step_lean(U, Um, K, offs, None, canon, canonical=True)
            digests[key] = digest(lean[0:3])
            require(digests[key] == digest(canon[0:3])
                    and lean[3:8].isnan().all().item()
                    and torch.equal(canon[3:6], U)
                    and not canon[6:8].any().item(),
                    f"K1 forms on {key}")
            if name not in ("b1", "rows49"):
                continue
            T = torch.empty_like(S)
            Tu = T[0:3]
            calls = {"lean": lambda: brick_step_lean(U, Um, K, offs, None,
                                                     Tu),
                     "canonical": lambda: brick_step_lean(
                         U, Um, K, offs, None, T, canonical=True)}
            if name == "rows49":
                del calls["canonical"]
            for form, fn in calls.items():
                for _ in range(3):
                    fn()
                ts = []
                for _ in range(reps):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    for _ in range(n):
                        fn()
                    b.record()
                    b.synchronize()
                    ts.append(a.elapsed_time(b) / n)
                ms = statistics.median(ts)
                rows = K1_FORM_ROWS[form]
                timing[f"{form} {str(dtype)[6:]}"
                       + ("" if name == "b1" else f" {name}")] = {
                    "ms": ms, "rows": rows,
                    "elements": int(np.prod([d - 1 for d in shape])),
                    "width": step_grid_of(offs, S.shape[1], dtype,
                                          dev.index)[5],
                    "GB_per_s": rows * S.shape[1] * S.element_size()
                    / (ms * 1e-3) / 1e9}
    require(digests == K1_LEAN_DIGESTS, f"K1 lean digests {digests}")
    return {"digests": digests, "timing": timing,
            "card": torch.cuda.get_device_name(dev)}


def seeded_brick(shape, axes, dtype, seed, device):
    """(S, K, offs) of a brick of node grid ``shape`` whose x, y and z
    step storage axes ``axes``: u and u- ~ N(0, 1) and rows 6:8 ~ N(0, 1)
    on its nodes, per-element (c1, c2, beta) where the element's corners
    lie on the grid (2 % of them zero), K rows 3:7 per node; zero
    padding to LEN (fused_brick.pallas_geometry)."""
    import numpy as np
    import torch
    from hercules_tpu_torch.solver.fused_brick import pallas_geometry
    n0, n1, n2 = shape
    st = (n1 * n2, n2, 1)
    sx, sy, sz = (st[a] for a in axes)
    offs = tuple((j & 1) * sx + (j >> 1 & 1) * sy + (j >> 2 & 1) * sz
                 for j in range(8))
    nb = n0 * n1 * n2
    LEN = pallas_geometry(nb)
    rng = np.random.default_rng(seed)
    S = np.zeros((8, LEN))
    u = rng.standard_normal((3, nb))
    S[0:3, :nb] = u
    S[3:6, :nb] = u - 0.1 * rng.standard_normal((3, nb))
    S[6:8, :nb] = rng.standard_normal((2, nb))
    K = np.zeros((8, LEN))
    i0, r = np.divmod(np.arange(nb), st[0])
    i1, i2 = np.divmod(r, st[1])
    ok = (i0 < n0 - 1) & (i1 < n1 - 1) & (i2 < n2 - 1)
    c = rng.uniform(0.5, 2.0, (3, nb)) * np.array([[1e-2], [2e-2], [0.3]])
    c[:, rng.random(nb) < 0.02] = 0.0
    K[0:3, :nb] = np.where(ok, c, 0.0)
    K[3:6, :nb] = rng.uniform(-1e-3, 1e-3, (3, nb))
    K[6, :nb] = rng.uniform(0.5, 1.5, nb)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(S), t(K), offs


def count_launches(counters, fn):
    """fn() with every launch counter set to 0 just before and read just
    after: (its result, {kernel: launches})."""
    for c in counters:
        c.launches = 0
    res = fn()
    return res, {c.__name__: c.launches for c in counters if c.launches}


def b1_source_sample(dtype, device, seed=21, k=4):
    """SourceSample at the shapes of validation B1 on the step route
    (port_bench/configs/b1_1hz.json): the seeded B1 brick (SEEDED_BRICKS,
    128^3 elements, LEN 2,147,328), its point source on the 8 nodes of
    the element at the centre, 256 stations on a 16 x 16 patch of
    elements one node plane below it with seeded trilinear weights, and
    k steps of increments (forces ~ N(0, 1) at B1's dt of 0.01 s, times
    the brick's inv_mass at the source nodes; source_sample.increments).
    Returns (S, io, inc [k, 3, 8], samples [k, 256, 3] of NaN)."""
    import numpy as np
    import torch
    from hercules_tpu_torch.kernels.source_sample import (SourceSample,
                                                          increments)
    shape, axes = SEEDED_BRICKS["b1"]
    S, K, offs = seeded_brick(shape, axes, dtype, seed, device)
    n2 = shape[2]
    node = lambda x, y, z: x + y * n2 + z * n2 * n2
    offs = np.asarray(offs)
    src = node(64, 64, 64) + offs
    els = np.array([node(56 + a, 56 + b, 65) for a in range(16)
                    for b in range(16)])
    st_pos = els[:, None] + offs[None, :]
    rng = np.random.default_rng(seed + 1)
    w = rng.uniform(0.0, 1.0, (len(els), 3))
    bits = (np.arange(8)[:, None] >> np.arange(3)[None, :]) & 1
    phi = np.prod(np.where(bits[None], w[:, None], 1.0 - w[:, None]),
                  axis=2)
    src_pos = torch.as_tensor(src, device=device)
    io = SourceSample(src_pos, torch.as_tensor(st_pos, device=device),
                      torch.as_tensor(phi, dtype=dtype, device=device))
    invm = K[6, src_pos].cpu().numpy()
    inc = torch.as_tensor(increments(rng.standard_normal((k, 8, 3)),
                                     0.01 ** 2, invm), device=device)
    samples = torch.full((k, len(els), 3), float("nan"), dtype=dtype,
                         device=device)
    return S, io, inc, samples


def source_sample_phase(dev):
    """Phase source_sample: SourceSample (csrc/source_sample.cu) on the
    card at B1's shapes (b1_source_sample), float32 and float64, four
    steps each: the add bit for bit the card's and the CPU's index_add_
    (source_sample_plain) and the rest of S untouched; the samples
    within 4e-6 (float32) / 1e-14 (float64) of max|sample| of the
    float64 einsum (sample_stations), a bound that the same sampling
    with two corners swapped misses by 100 times or more; a call without
    samples leaves the buffer as it was, one without increments leaves S
    as it was; sources sharing nodes add as the CPU's index_add_ adds
    them, in source order; one launch counted per call.  Returns the
    largest absolute sample error."""
    import torch
    from hercules_tpu_torch.kernels.brick_chunk import sample_stations
    from hercules_tpu_torch.kernels.source_sample import (
        SourceSample, source_sample_plain)
    t0 = time.perf_counter()
    cases, errs = [], []
    for dtype, tol in ((torch.float32, 4e-6), (torch.float64, 1e-14)):
        S, io, inc, smp = b1_source_sample(dtype, dev)
        before = SourceSample.launches
        for i in range(inc.shape[0]):
            got = S.clone()
            io(got, inc[i], smp[i])
            want = S.clone()
            source_sample_plain(want, inc[i], io.src_pos, None, None, None)
            on_cpu = S.cpu().clone()
            source_sample_plain(on_cpu, inc[i].cpu(), io.src_pos.cpu(), None,
                                None, None)
            same = torch.equal(got, want) and torch.equal(got.cpu(), on_cpu)
            moved = not torch.equal(got[0:3, io.src_pos], S[0:3, io.src_pos])
            ref = sample_stations(want.double(), io.st_pos,
                                  io.st_phi.double())
            scale = ref.abs().max().item()
            err = (smp[i].double() - ref).abs().max().item()
            swapped = sample_stations(want.double(),
                                      io.st_pos[:, [1, 0, 2, 3, 4, 5, 6, 7]],
                                      io.st_phi.double())
            miss = (swapped - ref).abs().max().item()
            cases.append({"dtype": str(dtype), "step": i,
                          "add_bit_identical": same, "sample_abs_err": err,
                          "sample_scale": scale, "bound": tol * scale,
                          "swapped_corners_err": miss})
            require(same and moved, f"source_sample add {cases[-1]}")
            require(err <= tol * scale and miss >= 100 * tol * scale,
                    f"source_sample samples {cases[-1]}")
            errs.append(err)
        # one half at a time
        keep = smp[0].clone()
        got = S.clone()
        io(got, inc[1])
        require(torch.equal(smp[0], keep),
                "source_sample wrote samples it was not given")
        got = S.clone()
        io(got, samples=smp[1])
        require(torch.equal(got, S), "source_sample added without increments")
        # sources sharing nodes
        pos = io.src_pos[[0, 3, 0, 5, 3, 0]]
        many = torch.randn((3, 6), dtype=torch.float64).to(dtype).to(dev)
        shared = SourceSample(pos)
        got = S.clone()
        shared(got, many)
        on_cpu = S.cpu().clone()
        on_cpu[0:3].index_add_(1, pos.cpu(), many.cpu())
        require(torch.equal(got.cpu(), on_cpu),
                f"source_sample shared nodes {dtype}")
        n = SourceSample.launches - before
        require(n == inc.shape[0] + 3, f"source_sample launches {n}")
    emit({"phase": "source_sample", "stations": 256, "sources": 8,
          "LEN": int(S.shape[1]), "cases": cases,
          "seconds": time.perf_counter() - t0})
    return max(errs)


def item7_phases(dev, work, counters, timed, lone, graph_ms):
    """The phases of nonlinear soil, DRM and buildings (ROADMAP Queue 1,
    item 7) on the CUDA device ``dev``, each printing one JSON line:
    nonlinear (the CLI at full width, both loadings, and the step's
    timing), nonlinear_accuracy, nonlinear_restart, drm and buildings
    (see the module docstring).  ``counters``: the launch counters;
    ``timed``, ``lone``, ``graph_ms``: main's CUDA-event timers.
    Returns {run: K1 launches}."""
    import numpy as np
    import torch

    from hercules_tpu_torch import cli
    from hercules_tpu_torch.convert import nonlinear_state
    from hercules_tpu_torch.fixtures import (
        BUILDING_DT, DRM_HYPOCENTER, DRM_SHALLOW_BOX, GRADED_Q_LAYERS,
        add_building_keys, add_drm_keys, add_nonlinear_keys,
        add_output_keys, box_dt, four_q_freq, write_box_case)
    from hercules_tpu_torch.nonlinear import nl_state_update
    from hercules_tpu_torch.sim import SimOutputs, Simulation
    from hercules_tpu_torch.solver import fused_mesh
    from hercules_tpu_torch.solver.bricks import build_plan
    from hercules_tpu_torch.utils import roofline
    from hercules_tpu_torch.utils.timers import GLOBAL_TIMERS

    f32, f64 = torch.float32, torch.float64
    # the nonlinear cut selects GRADED_Q_LAYERS' top 31.25 m (Vs 600 m/s,
    # von Mises, rate-independent, k = 1 kPa: fixtures.NL_PROPERTIES);
    # the source 40 m under station 0 (the waves reach it within the
    # 0.104 s of the full-width run)
    NL_CUT, NL_HYPO = 700.0, (263.0, 241.0, 40.0)
    out = {}

    def counted(fn):
        return count_launches(counters, fn)

    def want_k1(ran, steps, bricks, what):
        """K1's launches of a mesh-route run: once per brick and step."""
        require(ran == {"brick_step": steps * bricks},
                f"{what}: launches {ran}, want brick_step {steps} x "
                f"{bricks}")
        return ran["brick_step"]

    def nl_case(name, edge, steps, geostatic=False):
        """GRADED_Q_LAYERS at ``edge`` with nonlinear soil, 5 stations;
        with ``geostatic``, loading over 30 % of the run plus a 10 %
        cushion (the reactions captured at step 0.4 x steps)."""
        cv, ph, nu = write_box_case(os.path.join(work, name), edge, steps,
                                    5, layers=GRADED_Q_LAYERS,
                                    freq=four_q_freq(edge),
                                    hypocenter=NL_HYPO)
        dt = box_dt(edge)
        add_nonlinear_keys(nu, NL_CUT, **(dict(
            geostatic_s=0.3 * steps * dt, cushion_s=0.1 * steps * dt)
            if geostatic else {}))
        return cv, ph, nu

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).max()
        require(scale > 0, "zero reference")
        return float(np.abs(a - b).max() / scale)

    # ---- nonlinear: the CLI at full width ----------------------------
    t_phase = time.perf_counter()
    parts = ("Solver", "Solver plan", "Solver tables", "Solver time loop")
    full = {}
    for geo in (False, True):
        label = "geostatic" if geo else "plain"
        cv, ph, nu = nl_case(f"nl_full_{label}", 3.90625, 400, geo)
        rundir = os.path.dirname(os.path.dirname(ph))
        before = {k: GLOBAL_TIMERS.value(k) for k in parts}
        log = io.StringIO()

        def run():
            with contextlib.redirect_stdout(log):
                return cli.main(["--dtype=float32", cv, ph, nu])

        rc, ran = counted(run)
        with open(os.path.join(LOG, f"cli_nonlinear_{label}.log"), "w") as f:
            f.write(log.getvalue())
        require(rc == 0, f"nonlinear {label}: CLI exit code {rc}")
        spent = {k: GLOBAL_TIMERS.value(k) - before[k] for k in parts}
        with open(os.path.join(rundir, "monitor.txt")) as f:
            mon = f.read()
        route = re.findall(r"^solver path: (\S+)", mon, re.M)
        require(route == ["cuda_mesh"] and "solver path reason" not in mon,
                f"nonlinear {label}: route {route}")
        mesh = re.search(r"Total elements: (\d+)", mon).group(1)
        k1 = want_k1(ran, 400, 3, f"nonlinear {label}")
        st = [np.loadtxt(os.path.join(rundir, "stations", f"station.{i}"),
                         skiprows=1) for i in range(5)]
        heads = [open(os.path.join(rundir, "stations", f"station.{i}")
                      ).readline() for i in range(5)]
        nl_st = [i for i in range(5) if heads[i].rstrip().endswith("kh(Pa)")]
        require(nl_st and all(st[i].shape == (400, 4 + 17) for i in nl_st)
                and all(st[i].shape == (400, 4) for i in range(5)
                        if i not in nl_st),
                f"nonlinear {label}: station columns "
                f"{[s.shape for s in st]}")
        disp = np.stack([s[:, 1:4] for s in st])
        require(np.isfinite(disp).all() and np.abs(disp).max() > 0,
                f"nonlinear {label}: stations not finite and non-zero")
        dlam = max(float(st[i][:, 4 + 14].max()) for i in nl_st)
        require(dlam > 0, f"nonlinear {label}: no plastic flow at a "
                          f"station")
        full[label] = {
            "elements": int(mesh), "route": route[0], "launches": ran,
            "seconds": spent, "stations_in_nonlinear_elements": nl_st,
            "max_station_dlambda": dlam,
            "loop_ms_per_step": spent["Solver time loop"] / 400 * 1e3}
        out[f"nonlinear {label}"] = k1

    # the step at full width, float32, from a state after 200 steps: with
    # and without the subset pass (the same plan and K1 tables, the
    # nonlinear columns masked in both), and the pass alone
    cv, ph, nu = nl_case("nl_full_timing", 3.90625, 400)
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    plan = build_plan(sim.mesh)
    st_ = sim.stations
    bundle = fused_mesh.attach_nonlinear_mesh(
        sim.mesh, sim.params, sim.tables, sim.nl_tables, plan, f32, dev)
    mt = fused_mesh.MeshPallasTables(plan, sim.tables, sim.src_ids,
                                     st_.nodes, st_.phi, f32, dev,
                                     nl=bundle)
    (state, _), ran = counted(lambda: fused_mesh.run_mesh(
        mt, sim.src_forces, 200, sim.params.delta_t))
    out["nonlinear timing run"] = want_k1(ran, 200, 3,
                                          "nonlinear timing run")
    ep = nonlinear_state(state)[2]
    require(np.isfinite(ep).all() and ep.max() > 0,
            "nonlinear: no plastic flow in 200 steps")
    timing_res = {"nonlinear_elements": int(sim.nl_tables.n),
                  "elements": int(sim.mesh.lenum),
                  "plastic_quadrature_points_share":
                      float((ep > 0).mean()),
                  "nl_state_MB": sum(a.nbytes for a in nonlinear_state(
                      state)) / 1e6}
    spare = fused_mesh.init_mesh_state(mt)
    step = fused_mesh.make_mesh_step(mt)
    srcf1 = torch.as_tensor(sim.src_forces[200] * sim.params.delta_t ** 2,
                            dtype=f32, device=dev)
    mt_el = fused_mesh.MeshPallasTables(plan, sim.tables, sim.src_ids,
                                        st_.nodes, st_.phi, f32, dev)
    for b in range(mt.NB):          # the same masked K1 tables
        mt_el.steps[b] = mt.steps[b]
    step_el = fused_mesh.make_mesh_step(mt_el)
    spare_el = fused_mesh.init_mesh_state(mt_el)
    calls = {
        "nonlinear": lambda: step(state, spare, srcf1, 200),
        "elastic": lambda: step_el(state[:3], spare_el, srcf1, 200)}
    n = bundle["n"]

    def subset_pass():
        ue = fused_mesh._gather_corners(state[0], bundle["gather"], n,
                                        0).reshape(n, 24)
        s = nl_state_update(bundle["d"], ue, state[3][:3], bundle["dt"])
        fused_mesh._nl_subset_pass(mt, state[0], list(spare[0]), ue,
                                   s, 200)

    runs = {}
    for k in ("nonlinear", "elastic", "elastic", "nonlinear"):
        runs.setdefault(k, []).append((timed(calls[k], 30, 5),
                                       lone(calls[k], 30)))
    for k in ("nonlinear", "elastic"):
        back = min(b for b, _ in runs[k])
        alone = min(a for _, a in runs[k])
        try:
            dev_ms = graph_ms(calls[k], n=5)
        except RuntimeError as e:   # a step that cannot be captured
            dev_ms, timing_res[f"{k}_graph_error"] = None, str(e)[:200]
        timing_res[k] = {
            "step_ms_runs": [b for b, _ in runs[k]],
            "step_lone_ms_runs": [a for _, a in runs[k]],
            "step_ms": back, "step_lone_ms": alone,
            "step_device_ms": dev_ms,
            "host_share": None if dev_ms is None else 1 - dev_ms / alone}
    timing_res["subset_pass_ms"] = timed(subset_pass, 30, 5)
    timing_res["subset_pass_device_ms"] = graph_ms(subset_pass, n=5)
    d_nl = timing_res["nonlinear"]["step_device_ms"]
    timing_res["subset_pass_share_of_step_device"] = (
        None if d_nl is None
        else timing_res["subset_pass_device_ms"] / d_nl)
    timing_res["subset_pass_share_of_step_back_to_back"] = (
        timing_res["subset_pass_ms"]
        / timing_res["nonlinear"]["step_ms"])
    # where the pass's device time goes
    timing_res["subset_pass_kernels_ms"] = profile_kernels(subset_pass)
    del spare, spare_el, mt_el
    emit({"phase": "nonlinear", "card": roofline.card(),
          "edge_m": 3.90625, "steps": 400, "dtype": str(f32),
          "runs": full, "timing": timing_res,
          "seconds": time.perf_counter() - t_phase})
    del state, mt, bundle, sim

    # ---- nonlinear_accuracy: cuda_mesh against unstructured ----------
    t_phase = time.perf_counter()
    acc = {}
    for edge, steps, geo in ((62.5, 40, False), (62.5, 40, True),
                             (7.8125, 80, False), (7.8125, 80, True)):
        label = f"{edge} {'geostatic' if geo else 'plain'}"
        cv, ph, nu = nl_case(f"nl_acc_{label.replace(' ', '_')}", edge,
                             steps, geo)
        sim = Simulation.setup(ph, nu, cvmdb=cv)
        plan = build_plan(sim.mesh)
        res = {}
        for solver, dt_ in (("auto", f64), ("unstructured", f64),
                            ("auto", f32)):
            (state, smp), ran = counted(
                lambda: sim.run(device=dev, dtype=dt_, solver=solver))
            require(sim.solver_path_name == {"auto": "cuda_mesh"}.get(
                solver, solver), f"nonlinear accuracy {label}: route "
                f"{sim.solver_path_name}")
            k1 = (want_k1(ran, steps, len(plan.bricks),
                          f"nonlinear accuracy {label}")
                  if solver == "auto" else 0)
            require(solver == "auto" or not ran,
                    f"unstructured launched {ran}")
            u = (fused_mesh.mesh_u_global(plan, state[0], sim.mesh.nnum)
                 if solver == "auto" else state[0].cpu().numpy())
            res[solver, str(dt_)] = (u, nonlinear_state(state), smp)
            out[f"nonlinear accuracy {label} {solver} {dt_}"] = k1
        (um, pm, sm), (uu, pu, su) = (res["auto", str(f64)],
                                      res["unstructured", str(f64)])
        acc[label] = {
            "elements": sim.mesh.lenum, "nonlinear_elements": sim.nl_tables.n,
            "bricks": len(plan.bricks), "steps": steps,
            "f64_cuda_mesh_vs_unstructured_u": rel(um, uu),
            "f64_cuda_mesh_vs_unstructured_plastic": [
                rel(a, b) for a, b in zip(pm, pu)
                if np.abs(b).max() > 0],
            "plastic_quadrature_points_share": float((pu[2] > 0).mean()),
            "f32_vs_f64_stations": rel(res["auto", str(f32)][2], sm)}
        require(acc[label]["f64_cuda_mesh_vs_unstructured_u"] <= 5e-12
                and max(acc[label]["f64_cuda_mesh_vs_unstructured_plastic"])
                <= 5e-12 and acc[label]["f32_vs_f64_stations"] <= 1e-2
                and pu[2].max() > 0 and len(pu) == (4 if geo else 3),
                f"nonlinear accuracy {label}: {acc[label]}")
    emit({"phase": "nonlinear_accuracy", "cases": acc,
          "bounds": {"f64_cuda_mesh_vs_unstructured": 5e-12,
                     "f32_vs_f64_stations": 1e-2},
          "seconds": time.perf_counter() - t_phase})

    # ---- nonlinear_restart: a checkpoint at 200 of 400, resumed -------
    t_phase = time.perf_counter()
    cv, ph, nu = nl_case("nl_restart", 62.5, 400, True)
    add_output_keys(ph, nu, checkpointing_rate=200)
    rundir = os.path.dirname(os.path.dirname(ph))
    sim = Simulation.setup(ph, nu, cvmdb=cv)
    nb = len(build_plan(sim.mesh).bricks)
    (s1, smp1), ran1 = counted(lambda: sim.run(
        device=dev, dtype=f32, rundir=rundir,
        outputs=SimOutputs(sim.mesh, sim.params, rundir)))
    ck = os.path.join(rundir, "checkpoints")
    picked = [f for f in os.listdir(ck)
              if int(np.load(os.path.join(ck, f))["step"]) == 200]
    require(len(picked) == 1, f"checkpoints {os.listdir(ck)}")
    shutil.copy(os.path.join(ck, picked[0]),
                os.path.join(ck, "checkpoint.in"))
    (s2, smp2), ran2 = counted(lambda: sim.run(device=dev, dtype=f32,
                                               rundir=rundir))
    out["nonlinear restart"] = (want_k1(ran1, 400, nb, "restart run A")
                                + want_k1(ran2, 200, nb, "restart run B"))
    same = (np.array_equal(smp2, smp1[200:])
            and all(np.array_equal(a, b) for a, b in zip(
                nonlinear_state(s1), nonlinear_state(s2)))
            and all(torch.equal(a, b) for a, b in zip(s1[0], s2[0])))
    pl = nonlinear_state(s1)
    require(same and sim.start_step == 200 and np.abs(pl[3]).max() > 0
            and pl[2].max() > 0,
            "nonlinear restart: not bit for bit")
    emit({"phase": "nonlinear_restart", "route": sim.solver_path_name,
          "elements": sim.mesh.lenum, "steps": 400, "checkpoint": 200,
          "dtype": str(f32), "bit_for_bit": same,
          "launches": {"A": ran1, "B": ran2},
          "seconds": time.perf_counter() - t_phase})

    # ---- drm: part 1 recorded, part 2 replayed ------------------------
    t_phase = time.perf_counter()
    T = 200

    def drm_case(part):
        cv, ph, nu = write_box_case(
            os.path.join(work, f"drm_{part}"), 7.8125, T, 2,
            damping="none", layers=GRADED_Q_LAYERS,
            freq=four_q_freq(7.8125), hypocenter=DRM_HYPOCENTER)
        add_drm_keys(nu, os.path.join(work, "drm_files"), part,
                     box_dt(7.8125), box=DRM_SHALLOW_BOX)
        return Simulation.setup(ph, nu, cvmdb=cv)

    s1, s2 = drm_case("part1"), drm_case("part2")
    s2.src_forces = np.zeros_like(s2.src_forces)
    plan = build_plan(s1.mesh)
    nb = len(plan.bricks)
    m, ts = s2.mesh, s2.mesh.ticksize
    x, y, z = (getattr(m, f"node_{c}").astype(np.float64) * ts
               for c in "xyz")
    x0, y0, x1, y1, depth = DRM_SHALLOW_BOX
    inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1) & (z <= depth)
    on = np.zeros(m.nnum, bool)
    on[s2.drm_plan.node_ids] = True
    interior, exterior = inside & ~on, ~inside & ~on
    drm_res = {"elements": m.lenum, "bricks": nb,
               "drm_nodes": len(s2.drm_plan.node_ids),
               "drm_elements": len(s2.drm_plan.elem_idx),
               "interior_nodes": int(interior.sum()), "steps": T}
    for dt_ in (f32, f64):
        name = str(dt_).split(".")[1]
        for s in (s1, s2):
            s.drm_dir = os.path.join(work, f"drm_files_{name}")
        t0 = time.perf_counter()
        (st1, _), ran = counted(lambda: s1.run(device=dev, dtype=dt_))
        require(s1.solver_path_name == "cuda_mesh", "drm part1 route")
        out[f"drm part1 {name}"] = want_k1(ran, T, nb, "drm part 1")
        u1 = fused_mesh.mesh_u_global(plan, st1[0], m.nnum)
        scale = np.abs(u1).max()
        res = {"part1_s": time.perf_counter() - t0,
               "interior_share_of_max": float(np.abs(u1[interior]).max()
                                              / scale)}
        us = {}
        for solver in (("auto", "unstructured") if dt_ == f64
                       else ("auto",)):
            t0 = time.perf_counter()
            (st2, _), ran = counted(lambda: s2.run(device=dev, dtype=dt_,
                                                   solver=solver))
            want = "cuda_mesh" if solver == "auto" else solver
            require(s2.solver_path_name == want
                    and not s2.solver_path_reason, "drm part2 route")
            if solver == "auto":
                out[f"drm part2 {name}"] = want_k1(ran, T, nb, "drm part 2")
                u2 = fused_mesh.mesh_u_global(plan, st2[0], m.nnum)
            else:
                require(not ran, f"unstructured launched {ran}")
                u2 = st2[0].cpu().numpy()
            us[solver] = u2
            res[solver] = {
                "seconds": time.perf_counter() - t0,
                "interior": float(np.abs(u2[interior] - u1[interior]).max()
                                  / scale),
                "exterior": float(np.abs(u2[exterior]).max() / scale)}
        if dt_ == f64:
            res["cuda_mesh_vs_unstructured"] = rel(us["auto"],
                                                   us["unstructured"])
        drm_res[name] = res
    bound32 = 1e-3
    r64, r32 = drm_res["float64"], drm_res["float32"]
    require(all(r64[s]["interior"] <= 1e-9 and r64[s]["exterior"] <= 1e-9
                for s in ("auto", "unstructured"))
            and r64["cuda_mesh_vs_unstructured"] <= 5e-12
            and r64["interior_share_of_max"] > 1e-3
            and r32["auto"]["interior"] <= bound32
            and r32["auto"]["exterior"] <= bound32, f"drm: {drm_res}")
    emit({"phase": "drm", **drm_res,
          "bounds": {"float64": 1e-9, "cuda_mesh_vs_unstructured": 5e-12,
                     "float32": bound32},
          "seconds": time.perf_counter() - t_phase})

    # ---- buildings: carved, and fixed-base ---------------------------
    t_phase = time.perf_counter()
    bld = {}
    for fb in (False, True):
        label = "fixed_base" if fb else "carved"
        root = os.path.join(work, f"bldg_{label}")
        cv, ph, nu = write_box_case(root, 62.5, 40, 5, dt=BUILDING_DT)
        add_building_keys(root, nu, fixed_base=fb)
        sim = Simulation.setup(ph, nu, cvmdb=cv)
        runs = {}
        for d_ in (dev, torch.device("cpu")):
            (state, smp), ran = counted(lambda: sim.run(
                device=d_, dtype=f64, rundir=root))
            runs[d_.type] = (state, smp, ran, sim.solver_path_name,
                             sim.solver_path_reason)
        state, smp, ran, route, reason = runs[dev.type]
        plan = build_plan(sim.mesh)
        if fb:
            require(route == "unstructured" and "fixed-base" in reason
                    and not ran, f"buildings {label}: {route} {ran}")
            ids, which = sim.mesh.buildings.base_nodes(sim.mesh)
            p = sim.params
            series = sim.mesh.buildings.base_disp_series(
                p.end_time - p.start_time, p.delta_t, p.total_steps,
                rundir=root)
            u = state[0].cpu().numpy()
            require(np.array_equal(u[ids], series[-1, which])
                    and np.abs(series[-1]).max() > 0,
                    f"buildings {label}: base nodes")
        else:
            require(route == "cuda_mesh" and not reason,
                    f"buildings {label}: route {route}")
            out["buildings carved"] = want_k1(ran, 40, len(plan.bricks),
                                              "buildings carved")
        bld[label] = {
            "elements": sim.mesh.lenum, "bricks": len(plan.bricks),
            "loose": len(plan.loose_eidx), "route": route,
            "reason": reason, "launches": ran,
            "f64_card_vs_cpu_samples": rel(smp, runs["cpu"][1])}
        require(bld[label]["f64_card_vs_cpu_samples"] <= 1e-12
                and np.isfinite(smp).all(), f"buildings {label}: "
                f"{bld[label]}")
    emit({"phase": "buildings", "cases": bld, "bound": 1e-12,
          "seconds": time.perf_counter() - t_phase})
    return out


def timed(fn, reps, warm):
    """Median milliseconds of fn() over reps calls, after warm
    calls (CUDA events on the current stream)."""
    import torch
    for _ in range(warm):
        fn()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def lone(fn, reps=60, warm=5):
    """Median milliseconds of one call of fn() on an idle device:
    synchronise, then events around the call."""
    import torch
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def graph_ms(fn, n=20, reps=10):
    """Device ms of one fn() from a CUDA graph of n calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return timed(g.replay, reps, 2) / n


def profile_kernels(fn, n=3, top=12):
    """Where fn()'s device time goes: the profiler's kernels, as (name,
    device ms per call, launches per call), the largest first (a
    measurement: a profiler that does not run is reported as such)."""
    import torch
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()

        def dev_us(e):
            return getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0))

        ranked = sorted(prof.key_averages(), key=dev_us, reverse=True)
        return [(e.key[:80], dev_us(e) / (n * 1e3), e.count // n)
                for e in ranked[:top]]
    except Exception as e:        # reported, not hidden
        return f"not measured: {e}"


def kernel_vs_plain(mod, tier, LEN, n, dtype, dev, label, steps=5,
                    seed=13):
    """A fragment's step kernel (module ``mod`` of tier "elastic" (K1),
    "uniform" (K2) or "corner" (K4) on [*, LEN] arrays, its first n
    columns real) against its plain version on the card, from a random
    state, ``steps`` steps in ``dtype``: {"S": rel. error of u and u-[,
    "conv": of the memory variables]}; fails past 2e-13 (float64), 1e-4
    (float32) or 5e-3 (bfloat16 memory variables)."""
    import numpy as np
    import torch

    from hercules_tpu_torch.kernels.bkt_corner_step import \
        bkt_corner_step_plain
    from hercules_tpu_torch.kernels.bkt_step import bkt_step_plain
    from hercules_tpu_torch.kernels.brick_step import brick_step_plain

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).max()
        require(scale > 0 and np.isfinite(a).all(), "zero or bad reference")
        return float(np.abs(a - b).max() / scale)

    g = np.random.default_rng(seed)
    S = np.zeros((8, LEN))
    S[0:3, :n] = 1e-3 * g.standard_normal((3, n))
    S[3:6, :n] = S[0:3, :n] - 1e-4 * g.standard_normal((3, n))
    S = torch.as_tensor(S, dtype=dtype, device=dev)
    parts = [(S, S.clone())]
    if tier != "elastic":
        (shape, cdt), = mod.state_parts(LEN)
        cv = np.zeros(shape)
        cv[:, :n] = 1e-3 * g.standard_normal((shape[0], n))
        cv = torch.as_tensor(cv, dtype=dtype, device=dev).to(cdt)
        parts.append((cv, cv.clone()))
    a, b = [p[0] for p in parts], [p[1] for p in parts]
    for _ in range(steps):
        if len(a) == 1:
            a = [mod(a[0])]
            b = [brick_step_plain(b[0], mod.K, mod.offs, mod.ops)]
        else:
            a = list(mod(a[0], a[1]))
            if tier == "uniform":
                b = list(bkt_step_plain(b[0], b[1], mod.K, mod.offs,
                                        mod.scales, mod.rec))
            else:
                b = list(bkt_corner_step_plain(b[0], b[1], mod.K, mod.offs,
                                               mod.tab))
    e = {"S": rel(a[0][0:6].cpu(), b[0][0:6].cpu())}
    if len(a) > 1:
        e["conv"] = rel(a[1].double().cpu(), b[1].double().cpu())
    f64_ = dtype == torch.float64
    bound = {"S": 2e-13 if f64_ else 1e-4, "conv": 2e-13 if f64_ else 5e-3}
    require(all(v <= bound[k] for k, v in e.items()),
            f"{label}: kernel against plain {e}")
    return e


# Simulation.setup of the phases' multi-chip cases, by their arguments:
# the graded box at 3.90625 m serves phases multigpu and multigpu_graded
_SIMS = {}


def setup_case(work, name, edge, steps, write=None, prepare=None, **case):
    """The Simulation of a case written by ``write`` (write_box_case by
    default; 5 stations) under work/mc_<name> and, where given, changed
    by prepare(cvmdb, physics_in, numerical_in) before it is set up;
    set up once per arguments."""
    from hercules_tpu_torch.fixtures import write_box_case
    from hercules_tpu_torch.sim import Simulation
    key = (name, edge, steps, write, prepare, tuple(sorted(case.items())))
    if key not in _SIMS:
        files = (write or write_box_case)(
            os.path.join(work, f"mc_{name}"), edge, steps, 5, **case)
        if prepare is not None:
            prepare(*files)
        cv, ph, nu = files
        _SIMS[key] = (Simulation.setup(ph, nu, cv), files)
    return _SIMS[key]


def multigpu_phase(dev, work, counters, timed, lone, graph_ms):
    """Phase multigpu (ROADMAP Queue 1, item 8a): the multi-chip paths
    of ``hercules_tpu_torch/parallel/`` through
    ``Simulation.run(devices=[dev] * P)``, every rank on the one card
    (see the module docstring).  Prints one JSON line and returns
    {kernel: launches} of its multi-chip runs."""
    import numpy as np
    import torch

    from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, GRADED_LAYERS,
                                             THIN_Q_LAYERS, add_output_keys,
                                             four_q_freq, write_box_case)
    from hercules_tpu_torch.io.checkpoint import checkpoint_read
    from hercules_tpu_torch.parallel import comm_model, driver
    from hercules_tpu_torch.parallel.ranks import RankGroup
    from hercules_tpu_torch.parallel.slab import build_slab_tables
    from hercules_tpu_torch.sim import SimOutputs, Simulation
    from hercules_tpu_torch.utils import roofline

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    launches = {}
    res = {"card": roofline.card(), "runs": {}, "kernels_vs_plain": {},
           "replicas_bit_identical": True}
    kind = {"elastic": "brick_step", "uniform": "bkt_step",
            "corner": "bkt_corner_step"}

    def setup(name, edge, steps, **case):
        return setup_case(work, name, edge, steps, **case)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).max()
        require(scale > 0 and np.isfinite(a).all(), "zero or bad reference")
        return float(np.abs(a - b).max() / scale)

    def replicas(path, state):
        """Both copies of every shared plane (slab) and every local copy
        of a node (sharded) hold the same bits of u and u-."""
        if path.name == "sharded":
            for k, glob in ((0, path.u_global(state)),
                            (1, path.up_global(state))):
                for s, g in zip(state, path.st.local_globals):
                    ok = np.array_equal(s[k][:len(g)].cpu().numpy(), glob[g])
                    require(ok, f"sharded replicas differ ({k})")
            return
        pl = path.st.nyp * path.st.nxp
        for r in range(path.n_dev - 1):
            zb = int(path.st.ez_of[r]) * pl
            for a, b in zip(path.step.fields(state[r]),
                            path.step.fields(state[r + 1])):
                require(torch.equal(a[:, zb:zb + pl], b[:, :pl]),
                        f"{path.name}: plane copies of ranks {r}, {r + 1}")

    def name_of(dtype):
        return str(dtype).removeprefix("torch.")

    def mc(sim, label, P, dtype, mc_path="slab_pallas", steps=None, **kw):
        """A multi-chip run, its launches counted: (state, samples,
        path)."""
        t0 = time.perf_counter()
        (state, samp), ran = count_launches(counters, lambda: sim.run(
            devices=[dev] * P, dtype=dtype, mc_path=mc_path,
            total_steps=steps, **kw))
        secs = time.perf_counter() - t0
        path = sim.mc_path
        T = (steps or sim.params.total_steps) - sim.start_step
        want = ({} if mc_path in ("sharded", "slab")
                else {kind[path.step.tier]: T * P})
        if path.name == "slab_pallas":
            # one SourceSample launch a step for each rank's sources,
            # one for each rank's stations
            users = (sum(io.L > 0 for io in path.step.io)
                     + sum(x is not None for x in path._st or ()))
            if users:
                want["SourceSample"] = T * users
        require(ran == want, f"{label}: launches {ran}, want {want}")
        require(sim.solver_path_name == f"mc:{mc_path}",
                f"{label}: route {sim.solver_path_name}")
        require(np.isfinite(samp).all() and np.abs(samp).max() > 0,
                f"{label}: stations")
        for k, v in ran.items():
            launches[k] = launches.get(k, 0) + v
        replicas(path, state)
        res["runs"][label] = {"path": path.name, "ranks": P,
                              "dtype": name_of(dtype), "steps": T,
                              "launches": ran, "seconds": secs}
        return state, samp, path

    def single(sim, dtype, solver="auto", steps=None):
        _, samp = sim.run(device=dev, dtype=dtype, solver=solver,
                          total_steps=steps)
        return samp

    def vs_plain(path, label, steps=5):
        """Rank 0's and the last rank's step kernel against its plain
        version on the card (kernel_vs_plain)."""
        res["kernels_vs_plain"][label] = {
            f"rank {r}": kernel_vs_plain(
                path.step.mods[r][0], path.step.tier, path.step.LEN,
                len(path.st.gnid_local[r]), path.dtype, dev,
                f"{label} rank {r}", steps)
            for r in (0, path.n_dev - 1)}

    # ---- the 2^20 boxes: K1 at P = 2, 3, 4; K2 and K4 at P = 4 -------
    sim_b, _ = setup("box", 7.8125, 400)
    require(sim_b.mesh.lenum == 1 << 20, "2^20 box")
    ref = {d: single(sim_b, d) for d in (f32, f64)}
    acc = {}
    paths = {}
    for P in (2, 3, 4):
        got = {}
        for d in (f32, f64):
            _, got[d], paths[(P, d)] = mc(
                sim_b, f"box P={P} {name_of(d)}", P, d)
        acc[f"box P={P}"] = {
            "f64_vs_single_f64": rel(got[f64], ref[f64]),
            "f32_vs_f64": rel(got[f32], got[f64]),
            "f32_vs_single_f32": rel(got[f32], ref[f32])}
    # the plain slab step on the card (torch ops: the JAX package's
    # XLA slab algebra) against the kernels' path, float64
    st_p, samp_p, path_p = mc(sim_b, "box P=4 float64 plain slab", 4, f64,
                              mc_path="slab")
    acc["box P=4 kernels_vs_plain_slab_f64"] = rel(got[f64], samp_p)
    for P in (3, 4):
        vs_plain(paths[(P, f64)], f"K1 2^20 P={P} float64")
        vs_plain(paths[(P, f32)], f"K1 2^20 P={P} float32")
    for name, case in (("bkt", dict(damping="bkt")),
                       ("thin", dict(damping="bkt", layers=THIN_Q_LAYERS,
                                     freq=four_q_freq(7.8125)))):
        sim, _ = setup(name, 7.8125, 400, **case)
        require(sim.mesh.lenum == 1 << 20, f"2^20 {name} box")
        r64 = single(sim, f64)
        got = {}
        for d in (f32, f64):
            _, got[d], p = mc(sim, f"{name} P=4 {name_of(d)}", 4, d)
            require(p.step.tier == ("uniform" if name == "bkt"
                                    else "corner"), f"{name}: tier")
            vs_plain(p, f"{kind[p.step.tier]} 2^20 P=4 {name_of(d)}")
        acc[f"{name} P=4"] = {"f64_vs_single_f64": rel(got[f64], r64),
                              "f32_vs_f64": rel(got[f32], got[f64])}
    for k, v in acc.items():
        if isinstance(v, dict):
            require(v["f64_vs_single_f64"] <= 1e-9 and v["f32_vs_f64"] <= 1e-2,
                    f"{k}: {v}")
            require(v.get("f32_vs_single_f32", 0) <= 1e-2, f"{k}: {v}")
        else:
            require(v <= 2e-13, f"{k}: {v}")

    # ---- the 62.5 m box on 8 ranks: one-layer fragments --------------
    for name, case in (("small", {}), ("small_bkt", dict(damping="bkt")),
                       ("small_four_q", dict(damping="bkt",
                                             layers=FOUR_Q_LAYERS,
                                             freq=four_q_freq(62.5)))):
        sim, _ = setup(name, 62.5, 40, **case)
        got = {}
        for d in (f32, f64):
            _, got[d], p = mc(sim, f"{name} P=8 {name_of(d)}", 8, d)
            require(set(p.st.ez_of) == {1}, "one layer per rank")
            vs_plain(p, f"{kind[p.step.tier]} 62.5 P=8 {name_of(d)}")
        _, plain, _ = mc(sim, f"{name} P=8 float64 plain slab", 8, f64,
                         mc_path="slab")
        acc[f"{name} P=8"] = {"kernels_vs_plain_slab_f64": rel(got[f64],
                                                              plain),
                              "f32_vs_f64": rel(got[f32], got[f64])}
        require(acc[f"{name} P=8"]["kernels_vs_plain_slab_f64"] <= 2e-13
                and acc[f"{name} P=8"]["f32_vs_f64"] <= 1e-2,
                f"{name} P=8: {acc[f'{name} P=8']}")

    # ---- sharded: the 2^20 box and the 2.4 M graded box --------------
    for name, sim, steps in (("box", sim_b, 400), ("graded", None, 200)):
        if sim is None:
            sim, _ = setup("graded", 3.90625, 200, layers=GRADED_LAYERS,
                           freq=four_q_freq(3.90625))
            require(sim.mesh.lenum == 2424832, "2.4 M graded box")
        r64 = single(sim, f64, solver="unstructured", steps=steps)
        got = {}
        for d in (f32, f64):
            _, got[d], _ = mc(sim, f"{name} sharded P=4 {name_of(d)}", 4, d,
                              mc_path="sharded", steps=steps)
        acc[f"{name} sharded P=4"] = {
            "f64_vs_unstructured_f64": rel(got[f64], r64),
            "f32_vs_f64": rel(got[f32], got[f64])}
        require(acc[f"{name} sharded P=4"]["f64_vs_unstructured_f64"] <= 1e-9
                and acc[f"{name} sharded P=4"]["f32_vs_f64"] <= 1e-2,
                f"{name} sharded: {acc[f'{name} sharded P=4']}")
    res["accuracy"] = acc

    # ---- restart: a step-200 checkpoint resumed bit for bit ----------
    restart = {}
    for mc_path in ("slab_pallas", "sharded"):
        runs = []
        for tag in ("a", "b"):
            cv, ph, nu = write_box_case(
                os.path.join(work, f"mc_restart_{mc_path}_{tag}"), 7.8125,
                400, 5, damping="bkt")
            add_output_keys(ph, nu, checkpointing_rate=200)
            root = os.path.dirname(os.path.dirname(ph))
            if tag == "b":
                ck = os.path.join(runs[0][3], "checkpoints")
                for f in ("checkpoint.out0", "checkpoint.out1"):
                    if checkpoint_read(os.path.join(ck, f))[0] == 200:
                        os.makedirs(os.path.join(root, "checkpoints"),
                                    exist_ok=True)
                        shutil.copy(os.path.join(ck, f), os.path.join(
                            root, "checkpoints", "checkpoint.in"))
            sim = Simulation.setup(ph, nu, cv)
            state, samp, path = mc(
                sim, f"restart {mc_path} {tag}", 4, f32, mc_path=mc_path,
                rundir=root,
                outputs=lambda s=sim, d=root: SimOutputs(s.mesh, s.params,
                                                         rundir=d))
            runs.append((state, samp, sim.start_step, root))
        (sa, pa, s0a, _), (sb, pb, s0b, _) = runs
        flat = lambda st: [x for s in st for x in driver._flat(s)]
        la, lb = flat(sa), flat(sb)
        same = (s0a, s0b) == (0, 200) and len(la) == len(lb) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))
        require(same and np.array_equal(pb, pa[200:]),
                f"restart {mc_path}: not bit for bit")
        restart[mc_path] = {"resumed_at": s0b, "arrays": len(la),
                            "bit_for_bit": True}
    res["restart"] = restart

    # ---- timing: the slab step at P = 1, 2, 4 on one card ------------
    timing = {}
    src = sim_b.src_forces
    for P in (1, 2, 4):
        if P == 1:
            st = build_slab_tables(sim_b.mesh, sim_b.tables, 1,
                                   src_ids=sim_b.src_ids)
            path = driver.SlabPallasPath(st, RankGroup([dev]), f32,
                                         sim_b.mesh.nnum)
        else:
            path = paths[(P, f32)]
        cols = path.src_cols()
        f = np.asarray(src[0:1])
        srcf = [None if not len(c) else torch.as_tensor(path.increments(
            r, f[:, c], sim_b.params.delta_t ** 2)[0], device=dev)
            for r, c in enumerate(cols)]
        box_ = [path.init_state()]

        def one_step():
            box_[0] = path.step.step(box_[0], srcf)

        spare = [torch.empty_like(s[0]) for s in box_[0]]

        def kernels_only():
            for r, s in enumerate(box_[0]):
                path.step.mods[r][0](s[0], out=spare[r])

        b2b = timed(one_step, 50, 5)
        alone = lone(one_step, reps=40)
        device = graph_ms(one_step)
        kdev = graph_ms(kernels_only)
        bound = sum(roofline.step_cost(m, path.step.LEN,
                                       int(path.st.ez_of[r]) * 128 * 128,
                                       f32).bound_ms
                    for r, (m,) in enumerate(path.step.mods))
        timing[f"P={P}"] = {
            "step_ms_back_to_back": b2b, "step_ms_alone": alone,
            "step_device_ms": device, "kernels_device_ms": kdev,
            "kernels_bound_ms": bound,
            "host_share": 1.0 - device / alone,
            "element_updates_per_s": sim_b.mesh.lenum / (b2b * 1e-3)}
    eups1 = sim_b.mesh.lenum / (timing["P=1"]["kernels_device_ms"] * 1e-3)
    res["timing_float32_2^20"] = timing
    res["prediction"] = {
        "what": "comm_model.predict: a prediction for P cards from the "
                "one-card K1 device rate, not a measurement",
        **{f"P={P}": comm_model.predict(
            comm_model.slab_comm_dims(129, 129, P), sim_b.mesh.lenum,
            eups1) for P in (2, 4, 8)}}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "multigpu", **res})
    return launches


def multigpu_graded_phase(dev, work, counters, timed, lone, graph_ms):
    """Phase multigpu_graded (ROADMAP Queue 1, item 8b): the graded
    multi-chip paths of ``hercules_tpu_torch/parallel/`` through
    ``Simulation.run(devices=[dev] * P)``, every rank on the one card
    (see the module docstring), on cases of 3.90625 m elements over 200
    steps.  Prints one JSON line and returns {kernel: launches} of its
    multi-chip runs."""
    import numpy as np
    import torch

    from hercules_tpu_torch.fixtures import (GRADED_LAYERS, GRADED_Q_LAYERS,
                                             add_nonlinear_keys,
                                             add_output_keys, four_q_freq,
                                             write_basin_case)
    from hercules_tpu_torch.io.checkpoint import checkpoint_read
    from hercules_tpu_torch.parallel import comm_model, driver
    from hercules_tpu_torch.parallel.gmesh import build_gmesh_tables
    from hercules_tpu_torch.parallel.gslab import build_gslab_tables
    from hercules_tpu_torch.sim import SimOutputs
    from hercules_tpu_torch.solver import fused_mesh
    from hercules_tpu_torch.utils import roofline

    f32, f64 = torch.float32, torch.float64
    edge, steps = 3.90625, 200
    t_phase = time.perf_counter()
    launches = {}
    res = {"card": roofline.card(), "edge_m": edge, "steps": steps,
           "runs": {}, "kernels_vs_plain": {}, "accuracy": {},
           "replicas_bit_identical": True}
    kind = {"elastic": "brick_step", "uniform": "bkt_step",
            "corner": "bkt_corner_step"}
    q = four_q_freq(edge)
    half = steps // 2

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).max()
        require(scale > 0 and np.isfinite(a).all(), "zero or bad reference")
        return float(np.abs(a - b).max() / scale)

    def name_of(dtype):
        return str(dtype).removeprefix("torch.")

    def replicas(path, state):
        """Both copies of every fragment-shared plane of every brick hold
        the same bits of u and u- (and of K2's memory variables), and
        gmesh's loose section is the same on every rank."""
        for b, fb in enumerate(path.st.bricks):
            pl = fb.plane
            for r in range(path.n_dev - 1):
                zb = int(fb.ez_of[r]) * pl
                lo, hi = state[r], state[r + 1]
                pairs = [(lo[0][b][0:6], hi[0][b][0:6])]
                if path.step.tier == "uniform":
                    pairs.append((lo[-1][b][0], hi[-1][b][0]))
                for x, y in pairs:
                    require(torch.equal(x[:, zb:zb + pl], y[:, :pl]),
                            f"{path.name}: brick {b} plane copies of ranks "
                            f"{r}, {r + 1}")
        if path.name == "gmesh":
            for s in state[1:]:
                require(torch.equal(s[1], state[0][1]),
                        "gmesh: loose sections differ")

    def rundir(label):
        d = os.path.join(work, "mcg_runs", label.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        return d

    def mc(sim, label, P, dtype, want, mc_path=None, **kw):
        """A multi-chip run, its launches counted (each brick's kernel on
        every rank and step): (state, samples, path)."""
        t0 = time.perf_counter()
        kw.setdefault("rundir", rundir(label))
        (state, samp), ran = count_launches(counters, lambda: sim.run(
            devices=[dev] * P, dtype=dtype, mc_path=mc_path, **kw))
        secs = time.perf_counter() - t0
        path = sim.mc_path
        require(sim.solver_path_name == f"mc:{want}",
                f"{label}: route {sim.solver_path_name} "
                f"({sim.solver_path_reason})")
        T = kw.get("total_steps", steps) - sim.start_step
        nb = len(path.st.bricks)
        expect = {kind[path.step.tier]: nb * P * T}
        require(ran == expect, f"{label}: launches {ran}, want {expect}")
        require(np.isfinite(samp).all() and np.abs(samp).max() > 0,
                f"{label}: stations")
        for k, v in ran.items():
            launches[k] = launches.get(k, 0) + v
        replicas(path, state)
        res["runs"][label] = {"path": path.name, "ranks": P,
                              "dtype": name_of(dtype), "steps": T,
                              "bricks": nb, "tier": path.step.tier,
                              "launches": ran, "seconds": secs,
                              "reason": sim.solver_path_reason}
        return state, samp, path

    def single(sim, dtype, label):
        t0 = time.perf_counter()
        _, samp = sim.run(device=dev, dtype=dtype, rundir=rundir(label))
        require(sim.solver_path_name == "cuda_mesh",
                f"{label}: route {sim.solver_path_name}")
        res["runs"][label] = {"path": "cuda_mesh", "dtype": name_of(dtype),
                              "seconds": time.perf_counter() - t0}
        return samp

    def vs_plain(path, label):
        """Rank 0's and the last rank's kernel on every brick's fragment
        (each fragment shape of the path: plane width, LEN, and the real
        columns of an uneven split) against its plain version
        (kernel_vs_plain)."""
        res["kernels_vs_plain"][label] = {
            f"rank {r} brick {b}": kernel_vs_plain(
                path.step.mods[r][b], path.step.tier, fb.LEN,
                len(fb.gnid_local[r]), path.dtype, dev,
                f"{label} rank {r} brick {b}")
            for b, fb in enumerate(path.st.bricks)
            for r in sorted({0, path.n_dev - 1})}

    def check(label, got, bound):
        res["accuracy"][label] = got
        require(got <= bound, f"{label}: {got} > {bound}")

    def checkpoints(cv, ph, nu):
        add_output_keys(ph, nu, checkpointing_rate=half)

    def nonlinear(cv, ph, nu):
        # the top 31.25 m nonlinear (Vs 600 m/s under the 700 m/s cut)
        add_nonlinear_keys(nu, 700.0)
        checkpoints(cv, ph, nu)

    def case(name, write=None, prepare=None, **kw):
        return setup_case(work, name, edge, steps, write=write,
                          prepare=prepare, **kw)[0]

    # ---- gslab: GRADED_LAYERS (K1 at P = 2, 4; K2 at P = 4) ----------
    paths = {}
    sim_g = case("graded", layers=GRADED_LAYERS, freq=q)
    E_g = sim_g.mesh.lenum
    ref = {d: single(sim_g, d, f"graded single {name_of(d)}")
           for d in (f32, f64)}
    for P in (2, 4):
        got = {}
        for d in (f32, f64):
            _, got[d], paths[("gslab", P, d)] = mc(
                sim_g, f"gslab P={P} {name_of(d)}", P, d, "gslab")
        check(f"gslab P={P} f64 vs cuda_mesh f64", rel(got[f64], ref[f64]),
              1e-9)
        check(f"gslab P={P} f32 vs f64", rel(got[f32], got[f64]), 1e-2)
    for d in (f32, f64):
        vs_plain(paths[("gslab", 4, d)], f"K1 gslab P=4 {name_of(d)}")
    for name, layers, tier in (("graded_bkt", GRADED_LAYERS, "uniform"),
                               ("graded_q_bkt", GRADED_Q_LAYERS, "corner")):
        sim = case(name, prepare=checkpoints, damping="bkt", layers=layers,
                   freq=q)
        if tier == "uniform":
            sim_ck = sim
        r64 = single(sim, f64, f"{name} single float64")
        got = {}
        for d in (f32, f64):
            _, got[d], p = mc(sim, f"gslab {name} P=4 {name_of(d)}", 4, d,
                              "gslab")
            require(p.step.tier == tier, f"{name}: tier {p.step.tier}")
            vs_plain(p, f"{kind[tier]} gslab P=4 {name_of(d)}")
        check(f"gslab {name} P=4 f64 vs cuda_mesh f64", rel(got[f64], r64),
              1e-9)
        check(f"gslab {name} P=4 f32 vs f64", rel(got[f32], got[f64]), 1e-2)

    # ---- gmesh: the basin (K1 and K2 at P = 2, 4) --------------------
    for damping in ("rayleigh", "bkt"):
        name = "basin" if damping == "rayleigh" else "basin_bkt"
        sim = case(name, write=write_basin_case, damping=damping)
        if damping == "rayleigh":
            sim_m = sim
        ref = {d: single(sim, d, f"{name} single {name_of(d)}")
               for d in ((f32, f64) if damping == "rayleigh" else (f64,))}
        for P in (2, 4):
            got = {}
            for d in (f32, f64):
                _, got[d], paths[("gmesh", damping, P, d)] = mc(
                    sim, f"gmesh {name} P={P} {name_of(d)}", P, d, "gmesh")
            check(f"gmesh {name} P={P} f64 vs cuda_mesh f64",
                  rel(got[f64], ref[f64]), 1e-9)
            check(f"gmesh {name} P={P} f32 vs f64", rel(got[f32], got[f64]),
                  1e-2)
        for d in (f32, f64):
            p = paths[("gmesh", damping, 4, d)]
            vs_plain(p, f"{kind[p.step.tier]} gmesh P=4 {name_of(d)}")
    E_m = sim_m.mesh.lenum
    res["elements"] = {"gslab": E_g, "gmesh": E_m}

    # ---- nonlinear soil on gmesh, and restarts on each path ----------
    # the source 40 m under station 0, as phase nonlinear puts it: the
    # waves reach the nonlinear layer within the run
    sim_nl = case("graded_q_nl", prepare=nonlinear, layers=GRADED_Q_LAYERS,
                  freq=q, hypocenter=(263.0, 241.0, 40.0))
    nl_n = sim_nl.nl_tables.n
    restart = {}
    for label, sim, P, want in (("gslab graded_bkt", sim_ck, 4, "gslab"),
                                ("gmesh nonlinear", sim_nl, 2, "gmesh")):
        runs = []
        for tag in ("a", "b"):
            d = rundir(f"restart {label} {tag}")
            if tag == "b":
                ck = os.path.join(runs[0][3], "checkpoints")
                os.makedirs(os.path.join(d, "checkpoints"), exist_ok=True)
                for f in ("checkpoint.out0", "checkpoint.out1"):
                    if checkpoint_read(os.path.join(ck, f))[0] == half:
                        shutil.copy(os.path.join(ck, f), os.path.join(
                            d, "checkpoints", "checkpoint.in"))
            state, samp, path = mc(
                sim, f"restart {label} {tag}", P, f32, want, rundir=d,
                outputs=lambda s=sim, d=d: SimOutputs(s.mesh, s.params,
                                                      rundir=d))
            runs.append((state, samp, sim.start_step, d))
        (sa, pa, s0a, _), (sb, pb, s0b, _) = runs
        la, lb = driver._flat(sa), driver._flat(sb)
        same = (s0a, s0b) == (0, half) and len(la) == len(lb) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))
        require(same and np.array_equal(pb, pa[half:]),
                f"restart {label}: not bit for bit")
        restart[label] = {"resumed_at": s0b, "arrays": len(la),
                          "bit_for_bit": True}
        if label == "gmesh nonlinear":
            ep = max(float(s[2][2].max()) for s in sa if s[2][2].numel())
            require(ep > 0, "gmesh nonlinear: no plastic flow")
            res["nonlinear"] = {"elements": sim.mesh.lenum,
                                "nonlinear_elements": nl_n, "ranks": P,
                                "steps": steps, "ep_max": ep,
                                "nl_station_columns": sorted(
                                    int(k) for k in sim.nl_station_extras)}
    res["restart"] = restart

    # ---- timing: the graded steps at P = 2, 4 beside cuda_mesh --------
    def kernels_of(path, state):
        """fn() launching every rank's and brick's kernel once."""
        spare = [[torch.empty_like(S) for S in s[0]] for s in state]

        def fn():
            for r, s in enumerate(state):
                for b, S in enumerate(s[0]):
                    path.step.mods[r][b](S, out=spare[r][b])
        return fn

    def bound_of(path):
        total = 0.0
        for r in range(path.n_dev):
            for mod, fb, b in zip(path.step.mods[r], path.st.bricks,
                                  path.st.plan.bricks):
                _, n1, n2 = b.node_shape
                total += roofline.step_cost(
                    mod, fb.LEN, int(fb.ez_of[r]) * (n1 - 1) * (n2 - 1),
                    f32).bound_ms
        return total

    def timing_of(step_fn, kern_fn, bound, E):
        b2b = timed(step_fn, 30, 5)
        alone = lone(step_fn, reps=30)
        device = graph_ms(step_fn)
        kdev = graph_ms(kern_fn)
        return {"step_ms_back_to_back": b2b, "step_ms_alone": alone,
                "step_device_ms": device, "kernels_device_ms": kdev,
                "kernels_bound_ms": bound,
                "host_share": 1.0 - device / alone,
                "element_updates_per_s": E / (b2b * 1e-3),
                "device_kernels_ms": profile_kernels(step_fn, top=8)}

    timing, eups1 = {}, {}
    for label, sim, key in (("gslab graded", sim_g, "gslab"),
                            ("gmesh basin", sim_m, "gmesh")):
        plan = sim.brick_plan()
        st_ = sim.stations
        mt = fused_mesh.MeshPallasTables(plan, sim.tables, sim.src_ids,
                                         st_.nodes, st_.phi, f32, dev)
        state = fused_mesh.init_mesh_state(mt)
        spare = fused_mesh.init_mesh_state(mt)
        mstep = fused_mesh.make_mesh_step(mt)
        srcf1 = torch.as_tensor(sim.src_forces[0] * sim.params.delta_t ** 2,
                                dtype=f32, device=dev)

        def mesh_kernels(mt=mt, state=state, spare=spare):
            for b, mod in enumerate(mt.steps):
                mod(state[0][b], out=spare[0][b])

        E = sim.mesh.lenum
        bound1 = sum(roofline.step_cost(
            mod, mt.LENs[b], int(np.prod(plan.bricks[b].shape)), f32).bound_ms
            for b, mod in enumerate(mt.steps))
        row = {"P=1 cuda_mesh": timing_of(
            lambda: mstep(state, spare, srcf1), mesh_kernels, bound1, E)}
        eups1[key] = E / (row["P=1 cuda_mesh"]["kernels_device_ms"] * 1e-3)
        for P in (2, 4):
            path = (paths[("gslab", P, f32)] if key == "gslab"
                    else paths[("gmesh", "rayleigh", P, f32)])
            cols = path.src_cols()
            f = np.asarray(sim.src_forces[0]) * sim.params.delta_t ** 2
            srcf = [None if not len(c) else torch.as_tensor(
                f[c], dtype=f32, device=dev) for c in cols]
            box_ = [path.init_state()]

            def one_step(path=path, box_=box_, srcf=srcf):
                box_[0] = path.step.step(box_[0], srcf, 0)

            row[f"P={P} {key}"] = timing_of(
                one_step, kernels_of(path, box_[0]), bound_of(path), E)
        timing[label] = row
    res["timing_float32"] = timing

    # ---- predictions for 2, 4 and 8 cards ----------------------------
    pred = {"what": "comm_model.predict: a prediction for P cards from the "
                    "one-card kernels' device rate on cuda_mesh, not a "
                    "measurement"}
    for key, sim, build, comm, legacy in (
            ("gslab", sim_g, build_gslab_tables, comm_model.gslab_comm, True),
            ("gmesh", sim_m, build_gmesh_tables, comm_model.gmesh_comm,
             False)):
        for P in (2, 4, 8):
            st_ = build(sim.mesh, sim.tables, P, src_ids=sim.src_ids,
                        plan=sim.brick_plan(legacy))
            pred[f"{key} P={P}"] = comm_model.predict(
                comm(st_), sim.mesh.lenum, eups1[key])
        pred[f"{key} plan_scaling_report"] = comm_model.plan_scaling_report(
            sim.brick_plan(legacy), sim.mesh.lenum, eups1[key])
    res["prediction"] = pred
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "multigpu_graded", **res})
    return launches


def nccl_check(cases, steps, work, timeout, count=None):
    """The 62.5 m slab boxes of phase multiprocess (Rayleigh: K1, one Q
    set: K2, four Q sets: K4; float64) in 2 processes over NCCL, each on
    a card of its own, held bit for bit against one process with two
    local ranks on two cards (``multihost.main``, a RankGroup).  Needs 2
    cards.  ``count(report, {kernel: launches})`` checks each child's
    launches.  Returns the phase's "nccl" entry."""
    import numpy as np
    import torch

    from hercules_tpu_torch.parallel import multihost as mh

    require(torch.cuda.device_count() >= 2, "NCCL needs two cards")
    kind = {"rayleigh": "brick_step", "bkt": "bkt_step",
            "four_q": "bkt_corner_step"}
    save = os.path.join(work, "mp_nccl")
    t0 = time.perf_counter()
    out = mh.spawn(2, ["--device", "cuda", "--backend", "nccl", "--dtype",
                       "float64", "--save", save,
                       *[a for c in cases.values() for a in c]],
                   timeout=timeout)
    secs = time.perf_counter() - t0
    with open(os.path.join(LOG, "multiprocess_nccl.log"), "w") as f:
        for k, (rc, text) in enumerate(out):
            f.write(f"==== process {k}: rc {rc}\n{text}\n")
    require(all(rc == 0 for rc, _ in out),
            f"multiprocess nccl: a child failed ({[rc for rc, _ in out]}): "
            f"{out[0][1][-1500:]} {out[1][1][-1500:]}")
    n = 0
    for k, (name, case) in enumerate(cases.items()):
        one = os.path.join(work, f"mp1_nccl_{name}")
        require(mh.main(["--device", "cuda", "--local-ranks", "2", "--dtype",
                         "float64", "--save", one, *case]) == 0,
                "one-process main")
        ref = np.load(os.path.join(one, "case0_float64_p0.npz"))
        for pid in range(2):
            base = os.path.join(save, f"case{k}_float64_p{pid}")
            arrs = np.load(base + ".npz")
            with open(base + ".json") as f:
                rep = json.load(f)
            require(rep["ranks"] == [pid], f"nccl ranks {rep['ranks']}")
            if count is not None:
                count(rep, {kind[name]: steps})
            for x in arrs.files:
                require(np.array_equal(arrs[x], ref[x]),
                        f"multiprocess nccl {name}: {x} differs from the "
                        f"one-process run")
                n += 1
    return {"run": True, "cards": torch.cuda.device_count(),
            "arrays_bit_identical": n, "spawn_s": secs}


def multiprocess_phase(dev, work, edge=7.8125, steps=(400, 200), small=62.5,
                       small_steps=40, chain_edge=7.8125, chain_steps=100,
                       timeout=300):
    """Phase multiprocess (ROADMAP Queue 1, item 8c): the multi-process
    launcher (``hercules_tpu_torch.parallel.multihost``) as 2 processes
    (``multihost.spawn``, each child given ``timeout`` seconds; a
    child's failure fails the phase) on the one card, over gloo with
    host copies (see the module docstring).  ``edge``, ``steps`` and the
    rest shrink it for a rehearsal on the CPU (``dev`` the CPU: the
    kernels' plain versions, no launch counted).  Prints one JSON line
    and returns {kernel: launches} of the child processes' runs."""
    import numpy as np
    import torch

    from hercules_tpu_torch.config import load_params
    from hercules_tpu_torch.cvm import CVM
    from hercules_tpu_torch.fixtures import (FOUR_Q_LAYERS, GRADED_LAYERS,
                                             four_q_freq, write_basin_case,
                                             write_box_case)
    from hercules_tpu_torch.meshgen import generate_mesh
    from hercules_tpu_torch.parallel import comm_model
    from hercules_tpu_torch.parallel import multihost as mh
    from hercules_tpu_torch.parallel.ranks import RankGroup
    from hercules_tpu_torch.utils import roofline

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    card = roofline.card() if cuda else "cpu rehearsal"
    res = {"card": card, "processes": 2, "transport": "gloo, host copies"}
    launches = {}
    kind = {"rayleigh": "brick_step", "bkt": "bkt_step",
            "four_q": "bkt_corner_step"}
    # the gloo runs: both processes on the one card
    env = dict(os.environ)
    if cuda:
        env["CUDA_VISIBLE_DEVICES"] = str(dev.index or 0)

    def spawn(tag, cases, dtypes, extra=(), env=env):
        save = os.path.join(work, f"mp_{tag}")
        t0 = time.perf_counter()
        out = mh.spawn(2, ["--device", dev.type, "--dtype", ",".join(dtypes),
                           "--save", save, *extra,
                           *[a for c in cases for a in c]],
                       timeout=timeout, env=env)
        secs = time.perf_counter() - t0
        with open(os.path.join(LOG, f"multiprocess_{tag}.log"), "w") as f:
            for k, (rc, text) in enumerate(out):
                f.write(f"==== process {k}: rc {rc}\n{text}\n")
        require(all(rc == 0 for rc, _ in out),
                f"multiprocess {tag}: a child failed "
                f"({[rc for rc, _ in out]}): {out[0][1][-1500:]} "
                f"{out[1][1][-1500:]}")
        return save, secs

    def load(save, k, d, pid):
        base = os.path.join(save, f"case{k}_{d}_p{pid}")
        with open(base + ".json") as f:
            return dict(np.load(base + ".npz")), json.load(f)

    def count(rep, want):
        """The child's launches: ``want`` {kernel: n} on the card and
        nothing else (none counted on the CPU)."""
        got = rep["launches"]
        require(got == (want if cuda else {}),
                f"multiprocess: launches {got}, expected {want}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    def u_global(parts, N):
        """The global [N, 3] field from (arrays, report) of processes
        saved with their gather maps."""
        u = None
        for arrs, rep in parts:
            for r in rep["ranks"]:
                a, g = arrs[f"r{r}_0"], arrs[f"g{r}"]
                if u is None:
                    u = np.zeros((N, 3), a.dtype)
                u[g] = a[0:3, :len(g)].T
        return u

    def same(a_parts, b, what):
        """Every array of every process's saved state in b's, bit for
        bit; the number of arrays compared."""
        n = 0
        for arrs, _ in a_parts:
            for f, x in arrs.items():
                require(f in b and b[f].dtype == x.dtype
                        and np.array_equal(b[f], x),
                        f"multiprocess {what}: {f} differs from the "
                        f"one-process run")
                n += 1
        return n

    def one_process(tag, case, dtypes, mode="auto"):
        """main in this process with two local ranks (a RankGroup) on
        the card: {dtype: (arrays, report)}."""
        save = os.path.join(work, f"mp1_{tag}")
        require(mh.main(["--device", dev.type, "--local-ranks", "2",
                         "--dtype", ",".join(dtypes), "--slab-step", mode,
                         "--save", save, *case]) == 0, "one-process main")
        return {d: load(save, 0, d, 0) for d in dtypes}

    # ---- the O(shard) slab pipeline at full width -------------------
    full = {"rayleigh": write_box_case(os.path.join(work, "mp_ray"), edge,
                                       steps[0], 2),
            "bkt": write_box_case(os.path.join(work, "mp_bkt"), edge,
                                  steps[1], 2, damping="bkt")}
    save, secs = spawn("full", list(full.values()), ("float32", "float64"))
    res["full"] = {"spawn_s": secs, "cases": {}}
    for k, (name, case) in enumerate(full.items()):
        T = steps[0] if name == "rayleigh" else steps[1]
        runs = {d: [load(save, k, d, pid) for pid in range(2)]
                for d in ("float32", "float64")}
        info = {"steps": T, "kernel": kind[name], "processes": []}
        for d, parts in runs.items():
            for arrs, rep in parts:
                require(rep["path"] == "slab"
                        and rep["shard_elements"] < rep["e_global"]
                        and rep["table_columns"] < rep["n_global"],
                        f"multiprocess {name}: a process held more than "
                        f"its block: {rep}")
                count(rep, {kind[name]: T * len(rep["ranks"])})
                info["processes"].append({
                    "dtype": d, "pid": rep["pid"],
                    "shard_elements": rep["shard_elements"],
                    "e_global": rep["e_global"], "mesh_s": rep["mesh_s"],
                    "tables_s": rep["tables_s"], "loop_s": rep["loop_s"],
                    "ms_per_step": rep["loop_s"] / T * 1e3,
                    "ms_per_step_after_first_chunk":
                        rep["ms_per_step_after_first_chunk"],
                    "exchange_s": rep["exchange_s"],
                    "exchange_wait_s": rep["exchange_wait_s"],
                    "local_umax": rep["local_umax"]})
        N = runs["float64"][0][1]["n_global"]
        u32 = u_global(runs["float32"], N)
        u64 = u_global(runs["float64"], N)
        scale = np.abs(u64).max()
        require(scale > 0 and np.isfinite(u32).all(), f"{name}: zero field")
        info["f32_vs_f64"] = float(np.abs(u32 - u64).max() / scale)
        require(info["f32_vs_f64"] <= 1e-2,
                f"multiprocess {name}: float32 {info['f32_vs_f64']} from "
                f"float64")
        res["full"]["cases"][name] = info

    # ---- timing: the 2-process step beside the one-process P = 2 step
    ray = full["rayleigh"]
    ref = one_process("full_ray", ray, ("float32",))["float32"]
    two = [load(save, 0, "float32", pid) for pid in range(2)]
    grid = two[0][1]["grid"]
    model = comm_model.slab_comm_dims(grid[2], grid[1], 2, dtype_bytes=4)
    per_step = [{"rank": r, "bytes": rep["sent"][str(r)] / steps[0],
                 "phases": rep["phases"][str(r)] / steps[0]}
                for _, rep in two for r in rep["ranks"]]
    require(all(p["bytes"] == model.bytes_out and p["phases"] == model.phases
                for p in per_step),
            f"multiprocess: exchange {per_step} against the model "
            f"{model.bytes_out} B, {model.phases} phases")
    res["timing_float32"] = {
        "card": card, "elements": two[0][1]["e_global"], "steps": steps[0],
        # the loop, and its steps after the first of its four chunks
        "two_process_ms_per_step": [rep["loop_s"] / steps[0] * 1e3
                                    for _, rep in two],
        "two_process_ms_per_step_after_first_chunk": [
            rep["ms_per_step_after_first_chunk"] for _, rep in two],
        "two_process_exchange_share": [rep["exchange_s"] / rep["loop_s"]
                                       for _, rep in two],
        "two_process_exchange_wait_share": [
            rep["exchange_wait_s"] / rep["loop_s"] for _, rep in two],
        "one_process_P2_ms_per_step": ref[1]["loop_s"] / steps[0] * 1e3,
        "one_process_P2_ms_per_step_after_first_chunk":
            ref[1]["ms_per_step_after_first_chunk"],
        "one_process_mesh_s": ref[1]["mesh_s"],
        "one_process_tables_s": ref[1]["tables_s"],
        "exchange_per_step_per_rank": per_step,
        "comm_model": {"bytes": model.bytes_out, "phases": model.phases},
        # not a gate: the two-process run's sources come from the shards
        "bit_identical_to_one_process": all(
            np.array_equal(arrs[f"r{r}_0"], ref[0][f"r{r}_0"])
            for arrs, rep in two for r in rep["ranks"])}

    # ---- bit for bit against one process, 62.5 m, float64 -----------
    small_cases = {
        "rayleigh": write_box_case(os.path.join(work, "mp_s_ray"), small,
                                   small_steps, 2),
        "bkt": write_box_case(os.path.join(work, "mp_s_bkt"), small,
                              small_steps, 2, damping="bkt"),
        "four_q": write_box_case(os.path.join(work, "mp_s_fourq"), small,
                                 small_steps, 2, damping="bkt",
                                 layers=FOUR_Q_LAYERS,
                                 freq=four_q_freq(small))}
    save, secs = spawn("small", list(small_cases.values()), ("float64",))
    res["small"] = {"spawn_s": secs, "steps": small_steps, "cases": {}}
    for k, (name, case) in enumerate(small_cases.items()):
        parts = [load(save, k, "float64", pid) for pid in range(2)]
        for _, rep in parts:
            count(rep, {kind[name]: small_steps * len(rep["ranks"])})
        ref = one_process(f"s_{name}", case, ("float64",))["float64"][0]
        n = same(parts, ref, name)
        plain = one_process(f"s_{name}_plain", case, ("float64",),
                            "plain")["float64"]
        N = parts[0][1]["n_global"]
        u, up = u_global(parts, N), u_global([plain], N)
        scale = np.abs(up).max()
        err = float(np.abs(u - up).max() / scale)
        require(scale > 0 and err <= 2e-13,
                f"multiprocess {name}: {err} of max|u| from SlabStep")
        res["small"]["cases"][name] = {"arrays_bit_identical": n,
                                       "vs_plain_SlabStep": err}

    # ---- the gather chain: gslab and gmesh, float64 -----------------
    chain = {"gslab": write_box_case(os.path.join(work, "mp_graded"),
                                     chain_edge, chain_steps, 2,
                                     layers=GRADED_LAYERS,
                                     freq=four_q_freq(chain_edge)),
             "gmesh": write_basin_case(os.path.join(work, "mp_basin"),
                                       chain_edge, chain_steps, 2)}
    save, secs = spawn("chain", list(chain.values()), ("float64",))
    res["chain"] = {"spawn_s": secs, "steps": chain_steps, "cases": {}}
    group1 = RankGroup([dev, dev])
    for k, (name, (cv, ph, nu)) in enumerate(chain.items()):
        parts = [load(save, k, "float64", pid) for pid in range(2)]
        p = load_params(ph, nu)
        t0 = time.perf_counter()
        mesh = mh.dangling_in_id_order(generate_mesh(p, CVM(cv)))
        one_save = os.path.join(work, f"mp1_chain_{name}")
        mh.solve_mesh(0, mesh, p, group1, [torch.float64], save=one_save)
        ref, rep1 = load(one_save, 0, "float64", 0)
        require(rep1["path"] == name, f"multiprocess: {name} took "
                                      f"{rep1['path']}")
        for _, rep in parts:
            require(rep["path"] == name, f"multiprocess chain: {rep}")
            count(rep, {"brick_step": rep["bricks"] * chain_steps
                        * len(rep["ranks"])})
        res["chain"]["cases"][name] = {
            "elements": int(mesh.lenum), "bricks": parts[0][1]["bricks"],
            "arrays_bit_identical": same(parts, ref, name),
            "one_process_s": time.perf_counter() - t0,
            "one_process_ms_per_step_after_first_chunk":
                rep1["ms_per_step_after_first_chunk"],
            "processes": [{k_: rep[k_] for k_ in (
                "pid", "mesh_s", "gather_s", "tables_s", "loop_s",
                "ms_per_step_after_first_chunk", "exchange_s",
                "exchange_wait_s")} for _, rep in parts]}

    # ---- NCCL: a card for each process ------------------------------
    if cuda and torch.cuda.device_count() >= 2:
        res["nccl"] = nccl_check(small_cases, small_steps, work, timeout,
                                 count)
    else:
        res["nccl"] = {"run": False,
                       "why": "one card: NCCL needs a card per process"}
        print("multiprocess: NCCL not run (one card; NCCL needs a card "
              "per process)", flush=True)

    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "multiprocess", **res})
    return launches


def tools_phase(dev, work, counters, elems=1_000_000, CH=400, steps=100,
                ndry=4, debug_edge=62.5):
    """Phase tools (ROADMAP Queue 1, items 9a-9c): the port's timing
    tools, its graft_entry and its NaN checker on the card (see the
    module docstring).  ``elems``, ``CH``, ``steps`` and ``ndry`` shrink
    it for a rehearsal on the CPU (``dev`` the CPU: the plain versions,
    no launch counted).  Prints one JSON line and returns {kernel:
    launches} of the tools' and the dry run's runs."""
    import numpy as np
    import torch

    from hercules_tpu_torch import graft_entry
    from hercules_tpu_torch.fixtures import write_box_case
    from hercules_tpu_torch.sim import Simulation
    from hercules_tpu_torch.solver.bricks import build_plan
    from hercules_tpu_torch.solver.fused_brick import (pallas_u_global,
                                                       run_pallas_solver)
    from hercules_tpu_torch.tools import perf_ab, resident_bench
    from hercules_tpu_torch.utils import roofline
    from hercules_tpu_torch.utils.debug import (check_state,
                                                make_chunk_checker)

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    card = roofline.card() if cuda else "cpu rehearsal"
    res = {"card": card}
    launches = {}

    def counted(fn):
        """fn() with the counters read before and after (never reset:
        the main path's counts stay whole); its lines, and the launches
        between."""
        before = {c.__name__: c.launches for c in counters}
        buf = io.StringIO()
        out = fn(buf)
        print(buf.getvalue(), end="", flush=True)
        got = {c.__name__: c.launches - before[c.__name__] for c in counters
               if c.launches > before[c.__name__]}
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        return out, buf.getvalue().splitlines(), got

    def want(got, kernel, n, what):
        if cuda:
            require(got.get(kernel, 0) == n and set(got) == {kernel},
                    f"{what}: launches {got}, expected {n} of {kernel}")

    # ---- resident_bench: K5 on the box, CH steps per launch, 3 launches
    t0 = time.perf_counter()
    box = resident_bench.build(elems, "rayleigh")
    build_s = time.perf_counter() - t0
    rb, lines, got = counted(lambda out: resident_bench.run(
        CH, device=dev, problem=box, out=out))
    want(got, "brick_chunk", 3, "resident_bench")
    plan = build_plan(box[1])
    pt_dt = box[0].delta_t
    (u, up), _ = run_pallas_solver(
        plan, box[2], None, np.zeros((3 * CH, 0, 3)), 3 * CH, pt_dt,
        dtype=torch.float32, device=dev, chunk=CH, route="chunk",
        state=(rb["S0"],))
    same = bool(torch.equal(rb["S"][0:3], u) and torch.equal(rb["S"][3:6],
                                                             up))
    require(same, "resident_bench state differs from run_pallas_solver's "
                  "chunk route")
    res["resident_bench"] = {
        "elements": rb["elements"], "LEN": rb["LEN"], "chunk": CH,
        "box_build_s": build_s, "lines": lines, "launches": got,
        "compile_first_s": rb["compile_first_s"], "runs": rb["runs"],
        "state_bytes": rb["state_bytes"],
        "bytes_per_step": rb["bytes_per_step"], "bound_ms": rb["bound_ms"],
        "bit_identical_to_run_pallas_solver": same}

    # ---- perf_ab: the per-step route under two configs, two rounds
    configs = ["", "HT_BKT_UNIFORM=0"]
    for damping, kernel in (("rayleigh", "brick_step"), ("bkt", "bkt_step")):
        t0 = time.perf_counter()
        prob = box if damping == "rayleigh" else \
            resident_bench.build(elems, damping)
        build_s = time.perf_counter() - t0
        ab, lines, got = counted(lambda out: perf_ab.run(
            damping, steps, configs, device=dev, problem=prob, out=out))
        want(got, kernel, 2 * len(configs) * 2 * steps, f"perf_ab {damping}")
        routes = {(r["route"], r["tier"]) for r in ab.values()}
        require(len(routes) == 1, f"perf_ab {damping}: routes {routes}")
        res[f"perf_ab {damping}"] = {
            "steps": steps, "configs": configs, "box_build_s": build_s,
            "lines": lines, "launches": got,
            "route": ab[""]["route"], "tier": ab[""]["tier"],
            "us_per_step": {c or "(default)": r["us_per_step"]
                            for c, r in ab.items()},
            "eups": {c or "(default)": r["eups"] for c, r in ab.items()}}
    del box, prob

    # ---- graft_entry.entry: one step on the card; float64 against the
    # CPU over three steps
    fn, args = graft_entry.entry(device=dev)
    u2, u1 = fn(*args)
    require(bool(torch.isfinite(u2).all()) and u2.abs().max() > 0,
            "entry step")
    outs = {}
    for where in (dev, torch.device("cpu")):
        fn, (u, up, srcf) = graft_entry.entry(device=where,
                                              dtype=torch.float64)
        for _ in range(3):
            u, up = fn(u, up, srcf)
        outs[where.type] = u.cpu()
    scale = outs["cpu"].abs().max().item()
    err = (outs[dev.type] - outs["cpu"]).abs().max().item()
    require(scale > 0 and err <= 1e-12 * scale,
            f"entry float64 on {dev} against the CPU: {err} of {scale}")
    res["entry"] = {"dtype_step": "float32", "f64_3_steps_max_abs_err": err,
                    "f64_scale": scale, "bound": 1e-12}

    # ---- graft_entry.dryrun_multichip: every rank on the one card
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        legs = graft_entry.dryrun_multichip(ndry, device=dev)
    print(buf.getvalue(), end="", flush=True)
    kernel_of = {"1 slab_pallas": "brick_step", "1 restart": "brick_step",
                 "2 gslab": "brick_step", "3 gmesh": "brick_step",
                 "4 gmesh bkt": "bkt_step", "6 gmesh nonlinear": "brick_step"}
    for leg, r in legs.items():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
        if cuda and leg in kernel_of:
            require(r["launches"].get(kernel_of[leg], 0) > 0,
                    f"dry run leg {leg}: launches {r['launches']}")
    res["dryrun"] = {
        "ranks": ndry, "seconds": time.perf_counter() - t0,
        "lines": [ln for ln in buf.getvalue().splitlines()
                  if ln.startswith("[dryrun]")],
        "legs": {k: {f: v for f, v in r.items() if f != "samples"}
                 for k, r in legs.items()}}

    # ---- utils.debug: the checker as on_chunk passes a healthy run; a
    # NaN at node k raises naming k
    paths = write_box_case(os.path.join(work, "debug"), debug_edge, 40, 2)
    sim = Simulation.setup(paths[1], paths[2], cvmdb=paths[0])
    seen = []
    hook = make_chunk_checker(inner=lambda done, st: seen.append(done))
    state, _ = sim.run(device=dev, chunk=10, on_chunk=hook)
    require(seen == [10, 20, 30, 40], f"checker ran at {seen}")
    caught = {}
    plan = build_plan(sim.mesh)
    N = sim.mesh.nnum
    k = N // 3
    for label, field, col in (
            ("route layout", state[0].clone(),
             int(np.flatnonzero(plan.gnid_cat == k)[0])),
            ("global [N, 3]", torch.as_tensor(pallas_u_global(
                plan, state[0], N), device=dev), k)):
        if field.shape[0] in (3, 8):
            field[1, col] = float("nan")
        else:
            field[col, 1] = float("nan")
        try:
            check_state((field,), where="after step 40")
        except FloatingPointError as e:
            caught[label] = str(e)
        want_msg = f"non-finite displacement after step 40 at nodes [{col}]"
        require(caught.get(label) == want_msg,
                f"NaN check ({label}): {caught.get(label)!r}")
    res["debug"] = {"route": sim.solver_path_name, "chunks_checked": seen,
                    "nan_messages": caught}

    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "tools", **res})
    return launches


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hercules_tpu_torch.fixtures import (
        FOUR_Q_LAYERS, GRADED_LAYERS, GRADED_Q_LAYERS, GRADED_THIN_LAYERS,
        SOFT_FREQ, SOFT_LAYERS, THIN_Q_LAYERS, TWO_LAYERS, box_stats,
        four_q_freq, terashake_case, write_box_case)
    from hercules_tpu_torch.kernels import build, tiles
    from hercules_tpu_torch.kernels.bkt_chunk import (bkt_chunk,
                                                      bkt_chunk_plain)
    from hercules_tpu_torch.kernels.bkt_corner_step import (
        bkt_corner_step, bkt_corner_step_plain, corner_grid_of)
    from hercules_tpu_torch.kernels.bkt_node_step import (
        bkt_node_step, bkt_node_step_plain)
    from hercules_tpu_torch.kernels.bkt_step import (bkt_step,
                                                     bkt_step_plain)
    from hercules_tpu_torch.kernels.brick_chunk import (
        brick_chunk, brick_chunk_plain, sample_stations)
    from hercules_tpu_torch.kernels.brick_step import (
        brick_step, brick_step_plain, step_grid_of)
    from hercules_tpu_torch.kernels.source_sample import (
        SourceSample, increments, source_sample_plain)
    from hercules_tpu_torch.kernels.stream_add import (stream_add,
                                                       stream_add_plain)
    from hercules_tpu_torch.convert import mesh_state_from_jax
    from hercules_tpu_torch.sim import Simulation
    from hercules_tpu_torch.solver import brickstep, fused_mesh
    from hercules_tpu_torch.solver.assemble import assemble
    from hercules_tpu_torch.solver.bricks import build_plan
    from hercules_tpu_torch.solver.fused_brick import (
        PallasBrickTables, pallas_geometry, run_pallas_solver,
        source_increments)
    from hercules_tpu_torch.solver import fused_bktq
    from hercules_tpu_torch.tools import hbm_ceiling
    from hercules_tpu_torch.utils import roofline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    os.makedirs(LOG, exist_ok=True)
    open(os.path.join(LOG, "phases.jsonl"), "w").close()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_", dir=os.path.join(ROOT, "build"))
    rng = np.random.default_rng(20261016)
    f32, f64 = torch.float32, torch.float64
    dts = {"float32": f32, "float64": f64}
    kern = {}

    def box(edge, steps, n_st, name, **case):
        cv, ph, nu = write_box_case(os.path.join(work, name), edge, steps,
                                    n_st, **case)
        sim = Simulation.setup(ph, nu, cv)
        return sim, build_plan(sim.mesh), (cv, ph, nu)

    def tables(sim, plan, dtype, bkt_tier=None):
        st = sim.stations
        return PallasBrickTables(plan, sim.tables, src_ids=sim.src_ids,
                                 st_nodes=st.nodes, st_phi=st.phi,
                                 dtype=dtype, device=dev, bkt_tier=bkt_tier)

    def random_state(pt):
        """u ~ 1e-3 N(0, 1) on the brick's nodes, u- close to it, zero
        padding."""
        S = np.zeros((8, pt.LEN))
        u = 1e-3 * rng.standard_normal((3, pt.nb))
        S[0:3, :pt.nb] = u
        S[3:6, :pt.nb] = u - 1e-4 * rng.standard_normal((3, pt.nb))
        return torch.as_tensor(S, dtype=pt.dtype, device=dev)

    def k1_loop(pt, S, inc, plain):
        """K1 (or its plain version) step by step with the source adds."""
        S = S.clone()
        spare = torch.empty_like(S)
        for t in range(inc.shape[0]):
            if plain:
                Sn = brick_step_plain(S, pt.K, pt.offs, pt.step.ops)
            else:
                Sn = brick_step(S, pt.K, pt.offs, pt.step.ops, out=spare)
            Sn[0:3].index_add_(1, pt.src_pos, inc[t])
            S, spare = Sn, S
        return S

    def rel(a, b):
        scale = b[0:3].abs().max().item()
        require(scale > 0, "zero reference field")
        err = (a[0:6] - b[0:6]).abs().max().item()
        return err / scale, err

    def random_bkt_state(pt):
        """random_state's S and memory variables ~ 1e-3 N(0, 1) on the
        brick's nodes, in the storage type."""
        S = random_state(pt)
        cv = np.zeros((pt.step.conv_rows, pt.LEN))
        cv[:, :pt.nb] = 1e-3 * rng.standard_normal((pt.step.conv_rows,
                                                     pt.nb))
        return S, torch.as_tensor(cv, dtype=pt.dtype,
                                  device=dev).to(pt.step.conv_dtype)

    def k2_loop(pt, S, cv, inc, plain):
        """K2 (or its plain version) step by step with the source adds."""
        args = (pt.K, pt.offs, pt.step.scales, pt.step.rec)
        S, cv = S.clone(), cv.clone()
        spare, cspare = torch.empty_like(S), torch.empty_like(cv)
        for t in range(inc.shape[0]):
            if plain:
                Sn, cn = bkt_step_plain(S, cv, *args)
            else:
                Sn, cn = bkt_step(S, cv, *args, out=spare, conv_out=cspare)
            Sn[0:3].index_add_(1, pt.src_pos, inc[t])
            S, spare, cv, cspare = Sn, S, cn, cv
        return S, cv

    def random_bktq_state(pt):
        """random_state's S, then every memory-variable part of the
        tier (conv and the node tier's conv_mix) ~ 1e-3 N(0, 1) on the
        brick's columns, in the storage type."""
        parts = [random_state(pt)]
        for shape, dt in pt.step.state_parts(pt.LEN):
            x = np.zeros(shape)
            if len(shape) == 2:
                x[:, :pt.nb] = 1e-3 * rng.standard_normal((shape[0], pt.nb))
            else:
                x[:] = 1e-3 * rng.standard_normal(shape)
            parts.append(torch.as_tensor(x, dtype=pt.dtype,
                                         device=dev).to(dt))
        return parts

    def node_loop(pt, state, inc, plain):
        """The node route step by step: K3 (or its plain version), the
        mixed elements included, then the source adds.  Returns (the
        final state, samples [steps, ns, 3])."""
        st = [x.clone() for x in state]
        spare = [torch.empty_like(x) for x in st]
        names = ("out", "conv_out", "conv_mix_out")
        args = (pt.K, pt.offs, pt.step.tab)
        samples = []
        for t in range(inc.shape[0]):
            samples.append(sample_stations(st[0], pt.st_pos, pt.st_phi))
            if plain:
                new = list(bkt_node_step_plain(st[0], st[1], *args,
                                               pt.step.mix, *st[2:]))
            else:
                new = list(bkt_node_step(
                    st[0], st[1], *args, mix=pt.step.mix,
                    conv_mix=st[2] if len(st) > 2 else None,
                    **dict(zip(names, spare))))
            new[0][0:3].index_add_(1, pt.src_pos, inc[t])
            spare, st = st, new
        return st, torch.stack(samples)

    def k4_loop(pt, S, cv, inc, plain):
        """K4 (or its plain version) step by step with the source adds."""
        args = (pt.K, pt.offs, pt.step.tab)
        S, cv = S.clone(), cv.clone()
        spare, cspare = torch.empty_like(S), torch.empty_like(cv)
        for t in range(inc.shape[0]):
            if plain:
                Sn, cn = bkt_corner_step_plain(S, cv, *args)
            else:
                Sn, cn = bkt_corner_step(S, cv, *args, out=spare,
                                         conv_out=cspare)
            Sn[0:3].index_add_(1, pt.src_pos, inc[t])
            S, spare, cv, cspare = Sn, S, cn, cv
        return S, cv

    def crel(a, b):
        """Relative and absolute error of memory variables a against b."""
        b = b.double()
        scale = b.abs().max().item()
        require(scale > 0, "zero reference conv")
        err = (a.double() - b).abs().max().item()
        return err / scale, err

    # the launch counters of the kernels the solver routes launch
    counters = (brick_step, brick_chunk, bkt_step, bkt_chunk, bkt_node_step,
                bkt_corner_step, SourceSample)

    try:
        # ---- 1. build ------------------------------------------------
        t0 = time.perf_counter()
        so = build.build()
        build.lib()
        log = so.with_suffix(".log").read_text()
        # K4's grid as the library launches it (resident blocks, slab,
        # work items) against the host's mirror of its slab rule, on the
        # 2048-element and the 2^20-element boxes, by type and kappa
        grids = {}
        for label, (nx, ny, nz) in (("2048", (17, 17, 9)),
                                    ("2^20", (129, 129, 65))):
            offs = tuple((j & 1) + (j >> 1 & 1) * nx + (j >> 2 & 1) * nx * ny
                         for j in range(8))
            LEN = pallas_geometry(nx * ny * nz)
            for dtype in (f32, f64):
                for kappa in (0, 1):
                    res, slab, items = corner_grid_of(offs, LEN, dtype,
                                                      kappa)
                    grids[f"{label} {dtype} kappa={kappa}"] = {
                        "resident": res, "slab": slab, "items": items}
                    require((slab, items) == tiles.corner_grid(offs, LEN,
                                                               res),
                            f"K4 grid {grids}")
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "nvcc_seconds": build.build_seconds, "library": so.name,
              "tile_registers": tile_registers(log), "k4_grid": grids,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling entry" in ln]})

        sim_s, plan_s, _ = box(62.5, 40, 5, "small")
        sim_b, plan_b, _ = box(7.8125, 400, 5, "big")
        require(sim_b.mesh.lenum == 1 << 20, f"{sim_b.mesh.lenum} elements")
        dt2_s, dt2_b = sim_s.params.delta_t ** 2, sim_b.params.delta_t ** 2
        # the four-layer box with Rayleigh damping: one brick whose
        # elements carry four different (c1, c2, beta)
        sim_l, plan_l, _ = box(62.5, 40, 5, "layered", damping="rayleigh",
                               layers=FOUR_Q_LAYERS, freq=four_q_freq(62.5))
        dt2_l = sim_l.params.delta_t ** 2
        pt = tables(sim_l, plan_l, f64)
        valid = pt.K[0] != 0
        require(all(len(torch.unique(pt.K[r][valid])) == 4
                    for r in range(3)), "layered box coefficients")

        # ---- unstructured: the unstructured solver on the card -------
        from hercules_tpu_torch.solver import step as ustep
        from hercules_tpu_torch.utils.timers import GLOBAL_TIMERS
        t_phase = time.perf_counter()
        card = roofline.card()

        def flat_state(state):
            """u, u- and the memory variables of an unstructured state,
            on the host."""
            u, up, conv = state
            return [x.cpu() for x in (u, up, *(conv or ()))]

        u_cases = {}
        for label, case in (
                ("box", {}),
                ("graded", dict(layers=GRADED_LAYERS,
                                freq=four_q_freq(62.5))),
                ("soft_bkt", dict(damping="bkt", layers=SOFT_LAYERS,
                                  freq=SOFT_FREQ))):
            sim, _, _ = box(62.5, 40, 5, f"unstructured_{label}", **case)
            runs = {}
            for key, d_, dt_ in (("cuda_f64", dev, f64),
                                 ("cpu_f64", "cpu", f64),
                                 ("cuda_f32", dev, f32),
                                 ("cuda_f32_again", dev, f32)):
                for c in counters:
                    c.launches = 0
                state, smp = sim.run(device=d_, dtype=dt_,
                                     solver="unstructured")
                require(sim.solver_path_name == "unstructured",
                        f"unstructured {label}: {sim.solver_path_name}")
                require(not any(c.launches for c in counters),
                        f"unstructured {label}: a kernel was launched")
                require(np.isfinite(smp).all() and np.abs(smp).max() > 0,
                        f"unstructured {label} {key}: stations")
                runs[key] = (flat_state(state), smp)
            (g64, s64), (gc, sc) = runs["cuda_f64"], runs["cpu_f64"]
            f64_vs_cpu = max((a - b).abs().max().item()
                             / b.abs().max().item()
                             for a, b in zip(g64, gc) if b.abs().max() > 0)
            s32 = runs["cuda_f32"][1]
            st_rel = float(np.abs(s32 - s64).max() / np.abs(s64).max())
            same = (all(torch.equal(a, b) for a, b in zip(
                runs["cuda_f32"][0], runs["cuda_f32_again"][0]))
                and np.array_equal(s32, runs["cuda_f32_again"][1]))
            u_cases[label] = {
                "elements": sim.mesh.lenum, "nodes": sim.mesh.nnum,
                "dangling": len(sim.mesh.dn_ids),
                "damping": sim.tables.damping, "steps": 40,
                "state_arrays": len(g64),
                "f64_card_vs_cpu_rel": f64_vs_cpu,
                "f64_samples_card_vs_cpu_rel":
                    float(np.abs(s64 - sc).max() / np.abs(sc).max()),
                "f32_vs_f64_stations_rel": st_rel,
                "f32_repeat_bit_identical": same}
            require(f64_vs_cpu <= 1e-12 and st_rel <= 1e-2 and same,
                    f"unstructured {label}: {u_cases[label]}")
        # the route at 2^20 elements (the Rayleigh box), float32: its
        # time loop per step through Simulation.run beside the same box's
        # cuda_chunk (K5) and bricks loops, in turns (unstructured, chunk,
        # bricks, bricks, chunk, unstructured); its step back to back and alone, by device time
        # (a CUDA graph of 20 steps) and the host's share of the step
        loop_ms = {}
        for solver in ("unstructured", "auto", "bricks", "bricks", "auto",
                       "unstructured"):
            t_loop = GLOBAL_TIMERS.value("Solver time loop")
            sim_b.run(device=dev, dtype=f32, total_steps=40, solver=solver)
            loop_ms.setdefault(sim_b.solver_path_name, []).append(
                (GLOBAL_TIMERS.value("Solver time loop") - t_loop) / 40 * 1e3)
        require(sorted(loop_ms) == ["bricks", "cuda_chunk", "unstructured"],
                f"2^20 routes {sorted(loop_ms)}")
        st_b = sim_b.stations
        ufn, _ = ustep.make_step(sim_b.tables, sim_b.src_ids, st_b.nodes,
                                 st_b.phi, f32, device=dev)
        r_u = np.random.default_rng(5)
        u0 = 1e-3 * r_u.standard_normal((sim_b.mesh.nnum, 3))
        carry = [(torch.as_tensor(u0, dtype=f32, device=dev),
                  torch.as_tensor(u0 * (1 - 1e-3), dtype=f32, device=dev),
                  None)]
        src1 = torch.as_tensor(sim_b.src_forces[0] * dt2_b, dtype=f32,
                               device=dev)

        def ustep_call():
            carry[0] = ufn(carry[0], (src1, 0))[0]

        back = [timed(ustep_call, 30, 5), timed(ustep_call, 30, 5)]
        alone = [lone(ustep_call, 30), lone(ustep_call, 30)]
        device_ms = graph_ms(ustep_call)
        ucost = roofline.unstructured_cost(sim_b.tables, f32)
        emit({"phase": "unstructured", "card": card, "cases": u_cases,
              "bound_f64_card_vs_cpu": 1e-12, "bound_f32_vs_f64": 1e-2,
              "timing_2^20": {
                  "elements": sim_b.mesh.lenum, "dtype": str(f32),
                  "loop_ms_per_step_runs": loop_ms,
                  "loop_ms_per_step": {k: min(v)
                                       for k, v in loop_ms.items()},
                  "step_ms_runs": back, "step_lone_ms_runs": alone,
                  "step_ms": min(back), "step_lone_ms": min(alone),
                  "step_device_ms": device_ms,
                  "host_ms": min(alone) - device_ms,
                  "host_share": 1 - device_ms / min(alone),
                  "bytes": ucost.bytes, "flop": ucost.flop,
                  "bound_ms": ucost.bound_ms, "bound_by": ucost.bound_by,
                  "share_of_bound": ucost.bound_ms / device_ms},
              "seconds": time.perf_counter() - t_phase})
        del carry, ufn

        # ---- loh1: the LOH.1 gate on the card ------------------------
        from hercules_tpu_torch.cvm import CVM
        from hercules_tpu_torch.tools import loh1
        t_phase = time.perf_counter()
        loh_dir = os.path.join(work, "loh1")
        sim_loh = loh1.simulation(loh_dir)
        plan_loh = build_plan(sim_loh.mesh)
        loh1.check_meshes(sim_loh.mesh, loh1.fine_mesh(
            sim_loh.params, CVM(os.path.join(loh_dir, "loh1.e"))))
        require((sim_loh.mesh.lenum, sim_loh.mesh.nnum,
                 len(sim_loh.mesh.dn_ids), len(plan_loh.bricks),
                 len(plan_loh.loose_eidx)) == (5632, 7179, 800, 1, 1536),
                "LOH.1 graded mesh")
        loh_runs, loh_smp = {}, {}
        for solver in ("auto", "unstructured"):
            for c in counters:
                c.launches = 0
            t_run = time.perf_counter()
            _, smp = sim_loh.run(device=dev, dtype=f32, solver=solver)
            torch.cuda.synchronize()
            ran = {c.__name__: c.launches for c in counters if c.launches}
            scores = loh1.gof_scores(smp)
            loh_smp[solver, "float32"] = smp
            loh_runs[solver] = {
                "route": sim_loh.solver_path_name, "launches": ran,
                "steps": sim_loh.params.total_steps,
                "run_s": time.perf_counter() - t_run,
                "gof": {f"station{s_} component{c_}": v
                        for (s_, c_), v in scores.items()},
                "gof_min": min(scores.values())}
            require(len(scores) >= 6 and min(scores.values()) >= 8.0,
                    f"LOH.1 {solver}: {loh_runs[solver]}")
        require(loh_runs["auto"]["route"] == "cuda_mesh"
                and loh_runs["auto"]["launches"].get("brick_step", 0) > 0,
                f"LOH.1 auto: {loh_runs['auto']}")
        require(loh_runs["unstructured"]["route"] == "unstructured"
                and not loh_runs["unstructured"]["launches"],
                f"LOH.1 unstructured: {loh_runs['unstructured']}")
        loh1_launches = loh_runs["auto"]["launches"]["brick_step"]
        # the kernel route against the unstructured route on the same
        # inputs: float32 (the runs above) and float64 (run here, after
        # the launches were read)
        for solver in ("auto", "unstructured"):
            loh_smp[solver, "float64"] = sim_loh.run(
                device=dev, dtype=f64, solver=solver)[1]
        loh_cross = {}
        for dname, bound in (("float32", 1e-4), ("float64", 2e-13)):
            a, b = loh_smp["auto", dname], loh_smp["unstructured", dname]
            loh_cross[dname] = {
                "cuda_mesh_vs_unstructured_rel":
                    float(np.abs(a - b).max() / np.abs(b).max()),
                "bound": bound}
            require(loh_cross[dname]["cuda_mesh_vs_unstructured_rel"]
                    <= bound, f"LOH.1 cuda_mesh vs unstructured {dname}: "
                    f"{loh_cross[dname]}")
        emit({"phase": "loh1", "card": card, "dtype": str(f32),
              "elements": sim_loh.mesh.lenum, "nodes": sim_loh.mesh.nnum,
              "dangling": len(sim_loh.mesh.dn_ids), "gof_bound": 8.0,
              "runs": loh_runs, "cross_route": loh_cross,
              "seconds": time.perf_counter() - t_phase})

        # ---- nonlinear soil, DRM and buildings (Queue 1, item 7) -----
        item7_launches = item7_phases(dev, work, counters, timed, lone,
                                      graph_ms)

        # ---- multigpu: the slab and sharded paths on ranks of one card
        mc_launches = multigpu_phase(dev, work, counters, timed, lone,
                                     graph_ms)
        # ---- multigpu_graded: gslab and gmesh on ranks of one card ----
        mcg_launches = multigpu_graded_phase(dev, work, counters, timed,
                                             lone, graph_ms)
        # ---- multiprocess: 2 processes on the card over gloo ---------
        mp_launches = multiprocess_phase(dev, work)
        # ---- tools: the timing tools, graft_entry, the checker -----
        tools_launches = tools_phase(dev, work, counters)

        # ---- 2. K1 against its plain version ------------------------
        cases = []
        for label, sim, plan, dtype, steps, bound, dt2 in (
                ("box", sim_s, plan_s, f64, 40, 2e-13, dt2_s),
                ("box", sim_s, plan_s, f32, 20, 1e-4, dt2_s),
                ("layered", sim_l, plan_l, f64, 40, 2e-13, dt2_l),
                ("layered", sim_l, plan_l, f32, 20, 1e-4, dt2_l),
                ("box", sim_b, plan_b, f32, 10, 1e-4, dt2_b)):
            pt = tables(sim, plan, dtype)
            S0 = random_state(pt)
            inc = source_increments(pt, sim.src_forces, dt2, 0, steps)
            Sk = k1_loop(pt, S0, inc, plain=False)
            Sp = k1_loop(pt, S0, inc, plain=True)
            torch.cuda.synchronize()
            r, err = rel(Sk, Sp)
            cases.append({"case": label, "elements": sim.mesh.lenum,
                          "dtype": str(dtype), "steps": steps, "rel_err": r,
                          "max_abs_err": err, "bound": bound})
            require(r <= bound, f"K1 vs plain {cases[-1]}")
            require(not Sk[:, pt.nb:].any(), "K1 moved the padding")
        kern["brick_step_err"] = cases[-1]["max_abs_err"]
        # the launch grid the library chooses against the host's mirror
        # of its slab rule, one step of the layout S on each seeded brick:
        # u+ the synchronous march's bytes, u copied, zeros in rows 6:8
        # (the seeded rows 6:8 are not zero); the launches by
        # configuration
        brick_step.configs.clear()
        grids, digests = {}, {}
        for name, (shape, axes) in SEEDED_BRICKS.items():
            for dname in ("float32", "float64"):
                S, K, offs = seeded_brick(shape, axes, dts[dname], 21, dev)
                LEN = S.shape[1]
                got = step_grid_of(offs, LEN, dts[dname], dev.index)
                grids[f"{name} {dname}"] = got
                require(got[0] == tiles.STEP_STAGES
                        and got[3:] == tiles.step_grid(offs, LEN, got[2],
                                                       dts[dname]),
                        f"K1 grid {name} {dname}: {got}")
                out = brick_step(S, K, offs, None)
                digests[f"{name} {dname}"] = hashlib.sha256(
                    out[0:3].cpu().numpy().tobytes()).hexdigest()
                require(torch.equal(out[3:6], S[0:3])
                        and not out[6:8].any().item()
                        and S[6:8].any().item(),
                        f"K1 layout S rows 3:8 on {name} {dname}")
        require(digests == K1_LEAN_DIGESTS,
                f"K1 against the synchronous march: {digests}")
        # float32's tiles 44 wide on B1 and two planes, 32 on the graded
        # fine brick and rows49; float64's 32 everywhere
        require([g[5] for g in grids.values()]
                == [44, 32, 32, 32, 44, 32, 32, 32],
                f"K1 tile widths {grids}")
        for dname in ("float32", "float64"):
            b1 = grids[f"b1 {dname}"]
            require(brick_step.configs.get(
                (b1[0], b1[1], b1[3], b1[5]), 0) >= 1,
                f"K1 configurations {brick_step.configs}")
        forms = k1_forms(dev)
        emit({"phase": "k1", "cases": cases, "grids": grids,
              "digests_equal": True, "forms": forms,
              "configs": {str(k): v for k, v in brick_step.configs.items()},
              "launches": brick_step.launches})

        # ---- 3. K5 against the K1 step loop and its plain version ----
        cases = []
        for label, sim, plan in (("box", sim_s, plan_s),
                                 ("layered", sim_l, plan_l)):
            for dtype, sbound in ((f64, 1e-12), (f32, 1e-5)):
                pt = tables(sim, plan, dtype)
                S0 = random_state(pt)
                res = {}
                for route in ("chunk", "step"):
                    (u, up), smp = run_pallas_solver(
                        plan, sim.tables, sim.src_ids, sim.src_forces, 37,
                        sim.params.delta_t, st_nodes=sim.stations.nodes,
                        st_phi=sim.stations.phi, dtype=dtype, device=dev,
                        chunk=16, state=S0, route=route)
                    res[route] = (torch.cat([u, up]), smp)
                Sc, Ss = res["chunk"][0], res["step"][0]
                same = torch.equal(Sc, Ss)
                r, err = rel(Sc, Ss)
                sc = np.abs(res["step"][1]).max()
                srel = np.abs(res["chunk"][1] - res["step"][1]).max() / sc
                cases.append({"case": label, "elements": sim.mesh.lenum,
                              "dtype": str(dtype), "steps": 37, "chunk": 16,
                              "bit_identical": same, "rel_err": r,
                              "samples_rel_err": float(srel)})
                require(same, f"K5 vs K1 loop {cases[-1]}")
                require(srel <= sbound, f"K5 samples {cases[-1]}")
        pt = tables(sim_b, plan_b, f32)
        S0 = random_state(pt)
        srcf = source_increments(pt, sim_b.src_forces, dt2_b, 0, 10)
        Sk, smp_k = brick_chunk(S0.clone(), torch.empty_like(S0), pt.K,
                                pt.offs, pt.step.ops, srcf, pt.src_pos,
                                pt.st_pos, pt.st_phi)
        Sp, smp_p = brick_chunk_plain(S0.clone(), pt.K, pt.offs,
                                      pt.step.ops, srcf, pt.src_pos,
                                      pt.st_pos, pt.st_phi)
        torch.cuda.synchronize()
        r, err = rel(Sk, Sp)
        srel = ((smp_k - smp_p).abs().max() / smp_p.abs().max()).item()
        cases.append({"elements": sim_b.mesh.lenum, "dtype": str(f32),
                      "steps": 10, "vs": "brick_chunk_plain",
                      "rel_err": r, "max_abs_err": err,
                      "samples_rel_err": srel, "bound": 1e-4})
        require(r <= 1e-4 and srel <= 1e-4, f"K5 vs plain {cases[-1]}")
        kern["brick_chunk_err"] = err
        # K5 (its own march, 32-wide tiles) against the staged K1 step
        # loop (44-wide tiles in float32 on B1 and two planes) on the
        # seeded bricks: B1, the graded fine brick, two node planes, rows
        # of 49 nodes; u and u- bit for bit, and rows 6:8 each kernel's
        # own: K5 carries the seeded ones through, K1 writes zeros
        for name, (shape, axes) in SEEDED_BRICKS.items():
            nb = int(np.prod(shape))
            rs = np.random.default_rng(23)
            for dname, sbound in (("float64", 1e-12), ("float32", 1e-5)):
                dt_ = dts[dname]
                S0, K, offs = seeded_brick(shape, axes, dt_, 22, dev)
                src = torch.as_tensor(rs.choice(nb, 4, replace=False),
                                      device=dev)
                srcf = torch.as_tensor(1e-3 * rs.standard_normal((9, 3, 4)),
                                       dtype=dt_, device=dev)
                st_pos = torch.as_tensor(rs.choice(nb, (6, 8)), device=dev)
                st_phi = torch.as_tensor(rs.uniform(0, 0.25, (6, 8)),
                                         dtype=dt_, device=dev)
                Sc, smp_c = brick_chunk(S0.clone(), torch.empty_like(S0), K,
                                        offs, None, srcf, src, st_pos,
                                        st_phi)
                S, sp, smp = S0.clone(), torch.empty_like(S0), []
                for t in range(srcf.shape[0]):
                    smp.append(sample_stations(S, st_pos, st_phi))
                    Sn = brick_step(S, K, offs, None, out=sp)
                    Sn[0:3].index_add_(1, src, srcf[t])
                    S, sp = Sn, S
                smp = torch.stack(smp)
                torch.cuda.synchronize()
                srel = ((smp_c - smp).abs().max() / smp.abs().max()).item()
                same = (torch.equal(Sc[0:6], S[0:6])
                        and torch.equal(Sc[6:8], S0[6:8])
                        and not S[6:8].any().item())
                cases.append({"case": f"seeded {name}", "dtype": dname,
                              "steps": srcf.shape[0],
                              "bit_identical": same,
                              "samples_rel_err": srel})
                require(same and srel <= sbound,
                        f"K5 vs K1 loop {cases[-1]}")
        emit({"phase": "k5", "cases": cases,
              "launches": brick_chunk.launches})

        # ---- 3b. SourceSample at B1's shapes ----------------------------
        kern["SourceSample_err"] = source_sample_phase(dev)

        # ---- 4. the main path through the CLI ------------------------
        from hercules_tpu_torch import cli
        from hercules_tpu_torch.utils.timers import GLOBAL_TIMERS

        def main_path(phase, routes, kernels, edge=7.8125, tag="",
                      mesh=None, **case):
            """The CLI on the box at ``edge`` (2^20 elements by default),
            400 steps, 5 stations, float32 then float64; every launch
            counter set to 0 just before each run and read just after.
            ``tag`` names the run's directories and logs beside the
            phase's; ``mesh`` the (elements, nodes) of a graded case
            (box_stats gives the uniform box's).  Returns the launches of
            both runs, and of each run (``by_type``, under "float32" and
            "float64")."""
            E, N = box_stats(edge) if mesh is None else mesh
            runs = {}
            by_type = {}
            for dname in ("float32", "float64"):
                for c in counters:
                    c.launches = 0
                cv, ph, nu = write_box_case(
                    os.path.join(work, f"{phase}{tag}_{dname}"), edge, 400,
                    5, **case)
                parts = ("Solver", "Solver plan", "Solver tables",
                         "Solver time loop")
                before = {k: GLOBAL_TIMERS.value(k) for k in parts}
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = cli.main([f"--dtype={dname}", cv, ph, nu])
                with open(os.path.join(LOG,
                                       f"cli_{phase}{tag}_{dname}.log"),
                          "w") as f:
                    f.write(out.getvalue())
                require(rc == 0, f"CLI exit code {rc}")
                # the time step the run took, from its numerical.in
                with open(nu) as f:
                    dt_run = float(re.search(
                        r"^simulation_delta_time_sec\s*=\s*(\S+)",
                        f.read(), re.M).group(1))
                spent = {k: GLOBAL_TIMERS.value(k) - before[k]
                         for k in parts}
                rundir = os.path.dirname(os.path.dirname(ph))
                with open(os.path.join(rundir, "monitor.txt")) as f:
                    path = [ln.split()[2] for ln in f
                            if ln.startswith("solver path:")]
                st = np.stack([np.loadtxt(os.path.join(
                    rundir, "stations", f"station.{i}"), skiprows=1)
                    for i in range(5)])
                by_type[dname] = {c.__name__: c.launches for c in counters}
                runs[dname] = (path, st, spent, dt_run)
            launches = {k: by_type["float32"][k] + by_type["float64"][k]
                        for k in by_type["float32"]}
            launches["by_type"] = by_type
            launches["seconds"] = {d: runs[d][2] for d in runs}
            s32, s64 = runs["float32"][1], runs["float64"][1]
            st_rel = np.abs(s32[..., 1:] - s64[..., 1:]).max() / \
                np.abs(s64[..., 1:]).max()
            emit({"phase": phase, "tag": tag, "elements": E, "nodes": N,
                  "steps": 400, "stations": 5, "case": case,
                  "runs": {d: {"solver_path": runs[d][0],
                               "seconds": runs[d][2],
                               "steps_per_s": 400 / runs[d][2]["Solver"],
                               "element_updates_per_s":
                                   E * 400 / runs[d][2]["Solver"],
                               "wall_s_per_sim_s":
                                   runs[d][2]["Solver"] / (400 * runs[d][3]),
                               "loop_element_updates_per_s":
                                   E * 400 / runs[d][2]["Solver time loop"]}
                           for d in runs},
                  "f32_vs_f64_station_rel": float(st_rel),
                  "launches": launches})
            for d, want in zip(("float32", "float64"), routes):
                require(runs[d][0] == [want], f"{phase} {d} route")
                s_ = runs[d][1][..., 1:]
                require(np.isfinite(s_).all() and np.abs(s_).max() > 0,
                        f"{phase} {d} stations not finite and non-zero")
            require(st_rel <= 1e-2, f"{phase} f32 vs f64 stations {st_rel}")
            require(all(launches[k] > 0 for k in kernels),
                    f"a kernel of the {phase} path never ran: {launches}")
            return launches

        main_launches = main_path("main", ("cuda_chunk", "cuda_step"),
                                  ("brick_step", "brick_chunk"))

        # ---- 5. accuracy: f32 CUDA against f64 plain -----------------
        sim_a, plan_a, _ = box(15.625, 200, 5, "accuracy")
        _, s32 = sim_a.run(device=dev)
        require(sim_a.solver_path_name == "cuda_chunk", "accuracy route")
        pt = tables(sim_a, plan_a, f64)
        srcf = source_increments(pt, sim_a.src_forces,
                                 sim_a.params.delta_t ** 2, 0, 200)
        _, s64 = brick_chunk_plain(torch.zeros((8, pt.LEN), dtype=f64,
                                               device=dev),
                                   pt.K, pt.offs, pt.step.ops, srcf,
                                   pt.src_pos, pt.st_pos, pt.st_phi)
        s64 = s64.cpu().numpy()
        acc = float(np.abs(s32 - s64).max() / np.abs(s64).max())
        emit({"phase": "accuracy", "elements": sim_a.mesh.lenum,
              "steps": 200, "station_rel_err": acc, "bound": 1e-2})
        require(acc <= 1e-2, f"f32 stations vs f64 plain: {acc}")

        # ---- 6. K2 against its plain version ------------------------
        sim_sb, plan_sb, _ = box(62.5, 40, 5, "small_bkt", damping="bkt")
        sim_ss, plan_ss, _ = box(62.5, 40, 5, "soft_bkt", damping="bkt",
                                 layers=SOFT_LAYERS, freq=SOFT_FREQ)
        sim_bb, plan_bb, _ = box(7.8125, 400, 5, "big_bkt",
                                 damping="bkt")
        dt2_bb = sim_bb.params.delta_t ** 2
        # the soft box meshed at 2^20 elements (12 rows of bfloat16
        # memory variables in float32, bulk attenuation on): K6's shape
        # on the outputs phase's soft case
        sim_bs, plan_bs, _ = box(7.8125, 20, 5, "big_soft", damping="bkt",
                                 layers=SOFT_LAYERS,
                                 freq=1200.0 / (8 * 7.8125))
        require(sim_bs.mesh.lenum == 1 << 20, "soft 2^20 box")
        cases = []
        for label, sim, plan, dtype, steps, bound in (
                ("box", sim_sb, plan_sb, f64, 40, 2e-13),
                ("box", sim_sb, plan_sb, f32, 20, 1e-4),
                ("soft", sim_ss, plan_ss, f64, 40, 2e-13),
                ("soft", sim_ss, plan_ss, f32, 20, 1e-3),
                ("box", sim_bb, plan_bb, f64, 5, 2e-13),
                ("box", sim_bb, plan_bb, f32, 10, 1e-4)):
            pt = tables(sim, plan, dtype)
            S0, cv0 = random_bkt_state(pt)
            inc = source_increments(pt, sim.src_forces,
                                    sim.params.delta_t ** 2, 0, steps)
            Sk, ck = k2_loop(pt, S0, cv0, inc, plain=False)
            Sp, cp = k2_loop(pt, S0, cv0, inc, plain=True)
            torch.cuda.synchronize()
            r, err = rel(Sk, Sp)
            rc_, cerr = crel(ck, cp)
            cases.append({"case": label, "elements": sim.mesh.lenum,
                          "dtype": str(dtype),
                          "conv": str(pt.step.conv_dtype), "steps": steps,
                          "rel_err": r, "max_abs_err": err,
                          "conv_rel_err": rc_, "conv_max_abs_err": cerr,
                          "bound": bound})
            require(r <= bound and rc_ <= bound, f"K2 vs plain {cases[-1]}")
            require(not Sk[:, pt.nb:].any() and not ck[:, pt.nb:].any(),
                    "K2 moved the padding")
        kern["bkt_step_err"] = cases[-1]["max_abs_err"]
        emit({"phase": "k2", "cases": cases, "launches": bkt_step.launches})

        # ---- 7. K6 against the K2 step loop and its plain version ----
        cases = []
        for label, sim, plan in (("box", sim_sb, plan_sb),
                                 ("soft", sim_ss, plan_ss)):
            for dtype, sbound in ((f64, 1e-12), (f32, 1e-5)):
                pt = tables(sim, plan, dtype)
                S0, cv0 = random_bkt_state(pt)
                res = {}
                for route in ("chunk", "step"):
                    (u, up, c), smp = run_pallas_solver(
                        plan, sim.tables, sim.src_ids, sim.src_forces, 37,
                        sim.params.delta_t, st_nodes=sim.stations.nodes,
                        st_phi=sim.stations.phi, dtype=dtype, device=dev,
                        chunk=16, state=(S0, cv0), route=route)
                    res[route] = (torch.cat([u, up]), c, smp)
                same = (torch.equal(res["chunk"][0], res["step"][0])
                        and torch.equal(res["chunk"][1], res["step"][1]))
                r, _ = rel(res["chunk"][0], res["step"][0])
                rc_, _ = crel(res["chunk"][1], res["step"][1])
                sc = np.abs(res["step"][2]).max()
                srel = np.abs(res["chunk"][2] - res["step"][2]).max() / sc
                cases.append({"case": label, "elements": sim.mesh.lenum,
                              "dtype": str(dtype), "steps": 37, "chunk": 16,
                              "bit_identical": same, "rel_err": r,
                              "conv_rel_err": rc_,
                              "samples_rel_err": float(srel)})
                require(same, f"K6 vs K2 loop {cases[-1]}")
                require(srel <= sbound, f"K6 samples {cases[-1]}")
        pt = tables(sim_bb, plan_bb, f32)
        S0, cv0 = random_bkt_state(pt)
        srcf = source_increments(pt, sim_bb.src_forces, dt2_bb, 0, 10)
        bargs = (pt.K, pt.offs, pt.step.scales, pt.step.rec)
        Sk, ck, smp_k = bkt_chunk(S0.clone(), torch.empty_like(S0),
                                  cv0.clone(), torch.empty_like(cv0), *bargs,
                                  srcf, pt.src_pos, pt.st_pos, pt.st_phi)
        Sp, cp, smp_p = bkt_chunk_plain(S0.clone(), cv0.clone(), *bargs,
                                        srcf, pt.src_pos, pt.st_pos,
                                        pt.st_phi)
        torch.cuda.synchronize()
        r, err = rel(Sk, Sp)
        rc_, _ = crel(ck, cp)
        srel = ((smp_k - smp_p).abs().max() / smp_p.abs().max()).item()
        cases.append({"case": "box", "elements": sim_bb.mesh.lenum,
                      "dtype": str(f32), "steps": 10,
                      "vs": "bkt_chunk_plain", "rel_err": r,
                      "max_abs_err": err, "conv_rel_err": rc_,
                      "samples_rel_err": srel, "bound": 1e-4})
        require(r <= 1e-4 and rc_ <= 1e-4 and srel <= 1e-4,
                f"K6 vs plain {cases[-1]}")
        kern["bkt_chunk_err"] = err
        # the soft box at 2^20 (bfloat16 memory variables, bounded at
        # 5e-3 as in phases k3 and k4)
        pt = tables(sim_bs, plan_bs, f32)
        require(pt.step.conv_dtype == torch.bfloat16
                and pt.step.conv_rows == 12, "soft 2^20 conv layout")
        S0, cv0 = random_bkt_state(pt)
        srcf = source_increments(pt, sim_bs.src_forces,
                                 sim_bs.params.delta_t ** 2, 0, 10)
        bargs = (pt.K, pt.offs, pt.step.scales, pt.step.rec)
        Sk, ck, smp_k = bkt_chunk(S0.clone(), torch.empty_like(S0),
                                  cv0.clone(), torch.empty_like(cv0), *bargs,
                                  srcf, pt.src_pos, pt.st_pos, pt.st_phi)
        Sp, cp, smp_p = bkt_chunk_plain(S0.clone(), cv0.clone(), *bargs,
                                        srcf, pt.src_pos, pt.st_pos,
                                        pt.st_phi)
        torch.cuda.synchronize()
        r, err = rel(Sk, Sp)
        rc_, cerr = crel(ck, cp)
        srel = ((smp_k - smp_p).abs().max() / smp_p.abs().max()).item()
        cases.append({"case": "soft", "elements": sim_bs.mesh.lenum,
                      "dtype": str(f32), "conv": str(pt.step.conv_dtype),
                      "conv_rows": pt.step.conv_rows, "steps": 10,
                      "vs": "bkt_chunk_plain", "rel_err": r,
                      "max_abs_err": err, "conv_rel_err": rc_,
                      "conv_max_abs_err": cerr, "samples_rel_err": srel,
                      "bound": 1e-4, "conv_bound": 5e-3})
        require(r <= 1e-4 and srel <= 1e-4 and rc_ <= 5e-3,
                f"K6 vs plain {cases[-1]}")
        require(not Sk[:, pt.nb:].any() and not ck[:, pt.nb:].any(),
                "K6 moved the padding")
        kern["bkt_chunk_err"] = max(kern["bkt_chunk_err"], err)
        # the same buffers and the same src_pos tensor, its values moved
        # in place between two launches: K6 adds at the new nodes
        pt = tables(sim_sb, plan_sb, f64)
        S0, cv0 = random_bkt_state(pt)
        srcf = source_increments(pt, sim_sb.src_forces,
                                 sim_sb.params.delta_t ** 2, 0, 10)
        bargs = (pt.K, pt.offs, pt.step.scales, pt.step.rec)
        pos = pt.src_pos.clone()
        Sa, Sb_, ca, cb_ = (torch.empty_like(S0), torch.empty_like(S0),
                            torch.empty_like(cv0), torch.empty_like(cv0))
        for shift in (0, 1):
            pos.copy_((pt.src_pos + shift) % pt.nb)
            Sa.copy_(S0)
            ca.copy_(cv0)
            Sk, ck, _ = bkt_chunk(Sa, Sb_, ca, cb_, *bargs, srcf, pos,
                                  pt.st_pos, pt.st_phi)
        Sp, cp, _ = bkt_chunk_plain(S0.clone(), cv0.clone(), *bargs, srcf,
                                    pos, pt.st_pos, pt.st_phi)
        torch.cuda.synchronize()
        r, err = rel(Sk, Sp)
        rc_, _ = crel(ck, cp)
        cases.append({"case": "box, sources moved in place",
                      "elements": sim_sb.mesh.lenum, "dtype": str(f64),
                      "steps": 10, "vs": "bkt_chunk_plain", "rel_err": r,
                      "max_abs_err": err, "conv_rel_err": rc_,
                      "bound": 2e-13})
        require(r <= 2e-13 and rc_ <= 2e-13, f"K6 vs plain {cases[-1]}")
        emit({"phase": "k6", "cases": cases, "launches": bkt_chunk.launches})

        # ---- 8. the BKT main path through the CLI --------------------
        bkt_launches = main_path("main_bkt",
                                 ("cuda_bkt_chunk", "cuda_bkt_step"),
                                 ("bkt_step", "bkt_chunk"), damping="bkt")

        # ---- 9. accuracy: BKT f32 CUDA against f64 plain -------------
        sim_a, plan_a, _ = box(15.625, 200, 5, "accuracy_bkt",
                               damping="bkt")
        _, s32 = sim_a.run(device=dev)
        require(sim_a.solver_path_name == "cuda_bkt_chunk",
                "accuracy_bkt route")
        pt = tables(sim_a, plan_a, f64)
        srcf = source_increments(pt, sim_a.src_forces,
                                 sim_a.params.delta_t ** 2, 0, 200)
        zero = torch.zeros((8, pt.LEN), dtype=f64, device=dev)
        zconv = torch.zeros((pt.step.conv_rows, pt.LEN), dtype=f64,
                            device=dev)
        _, _, s64 = bkt_chunk_plain(zero, zconv, pt.K, pt.offs,
                                    pt.step.scales, pt.step.rec, srcf,
                                    pt.src_pos, pt.st_pos, pt.st_phi)
        s64 = s64.cpu().numpy()
        acc = float(np.abs(s32 - s64).max() / np.abs(s64).max())
        emit({"phase": "accuracy_bkt", "elements": sim_a.mesh.lenum,
              "steps": 200, "station_rel_err": acc, "bound": 1e-2})
        require(acc <= 1e-2, f"BKT f32 stations vs f64 plain: {acc}")

        # ---- 10. K3 (the mixed elements inside) against the plain route
        two = dict(damping="bkt", layers=TWO_LAYERS, freq=SOFT_FREQ)
        four = dict(damping="bkt", layers=FOUR_Q_LAYERS,
                    freq=four_q_freq(62.5))
        four_big = dict(damping="bkt", layers=FOUR_Q_LAYERS,
                        freq=four_q_freq(7.8125))
        thin_big = dict(damping="bkt", layers=THIN_Q_LAYERS,
                        freq=four_q_freq(7.8125))
        sim_2q, plan_2q, _ = box(62.5, 40, 5, "two_q", **two)
        sim_2s, plan_2s, _ = box(62.5, 40, 5, "two_q_shear",
                                 use_infinite_qk=True, **two)
        sim_4q, plan_4q, _ = box(62.5, 40, 5, "four_q", **four)
        sim_4b, plan_4b, _ = box(7.8125, 20, 5, "four_q_big", **four_big)
        require(sim_4b.mesh.lenum == 1 << 20, "four-layer 2^20 box")
        sim_th, plan_th, _ = box(7.8125, 20, 5, "thin_q_big", **thin_big)
        require(sim_th.mesh.lenum == 1 << 20, "thin-layer 2^20 box")
        # (case, sim, plan, type, steps, bound on S and samples, bound on
        # the memory variables); at 2^20 elements S alone is bounded
        # tightly: there a memory variable near the max that rounds to
        # the other bfloat16 neighbour differs by 2^-8 of itself, so the
        # memory variables are bounded at 5e-3, just above that
        cases = []
        for label, sim, plan, dtype, steps, bound, mbound in (
                ("two", sim_2q, plan_2q, f64, 40, 2e-13, 2e-13),
                ("two", sim_2q, plan_2q, f32, 20, 1e-3, 1e-3),
                ("two_shear", sim_2s, plan_2s, f32, 20, 1e-4, 1e-4),
                ("four", sim_4b, plan_4b, f64, 5, 2e-13, 2e-13),
                ("four", sim_4b, plan_4b, f32, 10, 1e-4, 5e-3)):
            pt = tables(sim, plan, dtype)
            require(pt.bkt_tier == "node", f"{label} tier {pt.bkt_tier}")
            state = random_bktq_state(pt)
            inc = source_increments(pt, sim.src_forces,
                                    sim.params.delta_t ** 2, 0, steps)
            (Sk, *mk), smp_k = node_loop(pt, state, inc, plain=False)
            (Sp, *mp), smp_p = node_loop(pt, state, inc, plain=True)
            torch.cuda.synchronize()
            r, err = rel(Sk, Sp)
            mem = [crel(a, b) for a, b in zip(mk, mp)]
            srel = ((smp_k - smp_p).abs().max()
                    / smp_p.abs().max()).item()
            cases.append({"case": label, "elements": sim.mesh.lenum,
                          "dtype": str(dtype),
                          "conv": str(pt.step.conv_dtype), "steps": steps,
                          "mixed": pt.step.mix_M,
                          "rel_err": r, "max_abs_err": err,
                          "conv_rel_err": mem[0][0],
                          "conv_mix_rel_err": mem[1][0],
                          "samples_rel_err": srel, "bound": bound,
                          "conv_bound": mbound})
            require(r <= bound and srel <= bound
                    and all(m[0] <= mbound for m in mem),
                    f"K3 route vs plain {cases[-1]}")
            require(not Sk[:, pt.nb:].any() and not mk[0][:, pt.nb:].any(),
                    "K3 moved the padding")
        kern["bkt_node_step_err"] = cases[-1]["max_abs_err"]
        emit({"phase": "k3", "cases": cases,
              "launches": bkt_node_step.launches})

        # ---- 11. K4 against its plain version ------------------------
        cases = []
        for label, sim, plan, dtype, steps, bound, mbound, tier in (
                ("four", sim_4q, plan_4q, f64, 40, 2e-13, 2e-13, None),
                ("four", sim_4q, plan_4q, f32, 20, 1e-3, 1e-3, None),
                ("two", sim_2q, plan_2q, f64, 40, 2e-13, 2e-13, "corner"),
                ("four", sim_4b, plan_4b, f32, 10, 1e-4, 5e-3, "corner"),
                ("thin", sim_th, plan_th, f32, 10, 1e-4, 5e-3, None),
                ("thin", sim_th, plan_th, f64, 5, 2e-13, 2e-13, None)):
            pt = tables(sim, plan, dtype, bkt_tier=tier)
            require(pt.bkt_tier == "corner", f"{label} tier {pt.bkt_tier}")
            S0, cv0 = random_bktq_state(pt)
            inc = source_increments(pt, sim.src_forces,
                                    sim.params.delta_t ** 2, 0, steps)
            Sk, ck = k4_loop(pt, S0, cv0, inc, plain=False)
            Sp, cp = k4_loop(pt, S0, cv0, inc, plain=True)
            torch.cuda.synchronize()
            r, err = rel(Sk, Sp)
            rc_, cerr = crel(ck, cp)
            cases.append({"case": label, "forced": tier,
                          "elements": sim.mesh.lenum, "dtype": str(dtype),
                          "conv": str(pt.step.conv_dtype),
                          "conv_rows": pt.step.conv_rows, "steps": steps,
                          "rel_err": r, "max_abs_err": err,
                          "conv_rel_err": rc_, "conv_max_abs_err": cerr,
                          "bound": bound, "conv_bound": mbound})
            require(r <= bound and rc_ <= mbound, f"K4 vs plain {cases[-1]}")
            require(not Sk[:, pt.nb:].any() and not ck[:, pt.nb:].any(),
                    "K4 moved the padding")
        kern["bkt_corner_step_err"] = cases[-1]["max_abs_err"]
        emit({"phase": "k4", "cases": cases,
              "launches": bkt_corner_step.launches})

        # ---- 12. the general-Q BKT main path through the CLI ---------
        node_launches = main_path(
            "main_bktq", ("cuda_bkt_node_step", "cuda_bkt_node_step"),
            ("bkt_node_step",), **four_big)
        # the corner tier's main path: the four-layer box at 62.5 m and
        # the thin-layer box at 2^20, each taking the tier by the rule;
        # one K4 launch per step
        corner_by_box = {
            box_: main_path("main_bktq_corner",
                            ("cuda_bkt_corner_step", "cuda_bkt_corner_step"),
                            ("bkt_corner_step",), tag=tag, **kw)
            for box_, tag, kw in (("2048", "", dict(edge=62.5, **four)),
                                  ("2^20_thin", "_thin", thin_big))}
        k4_by_type = {b: {d: n["bkt_corner_step"]
                          for d, n in v["by_type"].items()}
                      for b, v in corner_by_box.items()}
        require(all(v == {"float32": 400, "float64": 400}
                    for v in k4_by_type.values()),
                f"main_bktq_corner: K4 launches {k4_by_type} for 400 steps "
                f"of each type on each box")
        corner_launches = {"by_type": {
            d: {"bkt_corner_step": sum(v[d] for v in k4_by_type.values())}
            for d in ("float32", "float64")}}
        # one K3 launch per step, the mixed elements inside: the node
        # tier keeps no correction of its own after the kernel
        k3_by_type = {d: n["bkt_node_step"]
                      for d, n in node_launches["by_type"].items()}
        require(k3_by_type == {"float32": 400, "float64": 400}
                and not hasattr(fused_bktq, "bkt_mix_epilogue"),
                f"main_bktq: K3 launches {k3_by_type} for 400 steps of "
                f"each type")

        # ---- 13. accuracy: node tier f32 CUDA against f64 plain ------
        sim_a, plan_a, _ = box(15.625, 200, 5, "accuracy_bktq",
                               damping="bkt", layers=FOUR_Q_LAYERS,
                               freq=four_q_freq(15.625))
        _, s32 = sim_a.run(device=dev)
        require(sim_a.solver_path_name == "cuda_bkt_node_step",
                f"accuracy_bktq route {sim_a.solver_path_name}")
        pt = tables(sim_a, plan_a, f64)
        inc = source_increments(pt, sim_a.src_forces,
                                sim_a.params.delta_t ** 2, 0, 200)
        zero = [torch.zeros((8, pt.LEN), dtype=f64, device=dev)] + [
            torch.zeros(shape, dtype=dt, device=dev)
            for shape, dt in pt.step.state_parts(pt.LEN)]
        _, s64 = node_loop(pt, zero, inc, plain=True)
        s64 = s64.cpu().numpy()
        acc = float(np.abs(s32 - s64).max() / np.abs(s64).max())
        emit({"phase": "accuracy_bktq", "elements": sim_a.mesh.lenum,
              "mixed": pt.step.mix_M, "steps": 200,
              "station_rel_err": acc, "bound": 1e-2})
        require(acc <= 1e-2, f"node-tier f32 stations vs f64 plain: {acc}")

        # ---- 14. K1-K4 on the bricks of the graded plans ---------------
        def with_damping(sim, damping):
            """sim on the same mesh with ``damping``'s tables."""
            p2 = copy.copy(sim.params)
            p2.type_of_damping = damping
            return dataclasses.replace(sim, params=p2,
                                       tables=assemble(sim.mesh, p2))

        def graded(edge, layers=GRADED_LAYERS, **kw):
            return dict(layers=layers, freq=four_q_freq(edge), **kw)

        names = ("out", "conv_out", "conv_mix_out")

        def kernel_step(mod, parts, spare):
            """One launch of a brick's step module into spare."""
            if getattr(mod, "tier", None) is None:
                return [mod(parts[0], out=spare[0])]
            return list(mod(*parts, **dict(zip(names, spare))))

        def plain_step(mod, parts):
            """The same step on the module's plain version."""
            tier = getattr(mod, "tier", None)
            if tier is None:
                return [brick_step_plain(parts[0], mod.K, mod.offs,
                                         mod.ops)]
            if tier == "uniform":
                return list(bkt_step_plain(*parts[:2], mod.K, mod.offs,
                                           mod.scales, mod.rec))
            if tier == "node":
                return list(bkt_node_step_plain(*parts[:2], mod.K,
                                                mod.offs, mod.tab, mod.mix,
                                                *parts[2:]))
            return list(bkt_corner_step_plain(*parts[:2], mod.K, mod.offs,
                                              mod.tab))

        def random_parts(mod, LEN, nb, dtype):
            """S ~ random_state's on the brick's nb columns, then the
            tier's memory variables ~ 1e-3 N(0, 1) there, in the
            storage type."""
            S = np.zeros((8, LEN))
            u = 1e-3 * rng.standard_normal((3, nb))
            S[0:3, :nb] = u
            S[3:6, :nb] = u - 1e-4 * rng.standard_normal((3, nb))
            parts = [torch.as_tensor(S, dtype=dtype, device=dev)]
            shapes = ([] if getattr(mod, "tier", None) is None
                      else mod.state_parts(LEN))
            for shape, dt in shapes:
                x = np.zeros(shape)
                if len(shape) == 2:
                    x[:, :nb] = 1e-3 * rng.standard_normal((shape[0], nb))
                else:
                    x[:] = 1e-3 * rng.standard_normal(shape)
                parts.append(torch.as_tensor(x, dtype=dtype,
                                             device=dev).to(dt))
            return parts

        sim_g62, plan_g62, _ = box(62.5, 40, 5, "graded62", **graded(62.5))
        sim_g62b = with_damping(sim_g62, "bkt")
        sim_q62, plan_q62, _ = box(62.5, 40, 5, "graded_q62",
                                   **graded(62.5, GRADED_Q_LAYERS,
                                            damping="bkt"))
        require([b.nb for b in plan_g62.bricks] == [867, 162, 50],
                f"62.5 m plan {[b.nb for b in plan_g62.bricks]}")
        t0 = time.perf_counter()
        sim_g4, plan_g4, _ = box(3.90625, 400, 5, "graded4",
                                 **graded(3.90625))
        sim_g4b = with_damping(sim_g4, "bkt")
        setup_g4_s = time.perf_counter() - t0
        E4, N4 = sim_g4.mesh.lenum, sim_g4.mesh.nnum
        require(E4 == 2424832 and len(plan_g4.bricks) == 3
                and not len(plan_g4.loose_eidx)
                and all(b.axes == (1, 2, 0) for b in plan_g4.bricks),
                f"3.90625 m plan: {E4} elements, "
                f"{[(b.nb, b.axes) for b in plan_g4.bricks]}")
        fine4 = int(np.argmax([b.nb for b in plan_g4.bricks]))
        # the plans main_mesh_small drives through Simulation.run: the
        # two Q variants at 7.8125 m (the node tier, K3, and the corner
        # tier, K4, on the fine brick by the rule, mixed elements
        # included) and the TeraShake copy (one brick, K1); label ->
        # (sim, plan, tiers by the rule)
        tera = terashake_case(os.path.join(work, "tera"))
        sim_q7 = box(7.8125, 400, 5, "graded_q7", **graded(
            7.8125, GRADED_Q_LAYERS, damping="bkt"))[0]
        sim_t7 = box(7.8125, 400, 5, "graded_thin7", **graded(
            7.8125, GRADED_THIN_LAYERS, damping="bkt"))[0]
        sim_ts = Simulation.setup(tera[1], tera[2], tera[0])
        small = {label: (sim, build_plan(sim.mesh), tiers)
                 for label, sim, tiers in (
                     ("graded_q_7.8125", sim_q7,
                      ("uniform", "uniform", "node")),
                     ("graded_thin_7.8125", sim_t7,
                      ("uniform", "uniform", "corner")),
                     ("terashake", sim_ts, ("elastic",)))}
        # (label, sim, plan, bricks, forced tier, type, steps, bound on S,
        # bound on the memory variables): every brick of the 62.5 m plan
        # (867, 162 and 50 nodes) on each kernel, K3 and K4 forced on the
        # uniform ones; the reordered bricks of the 3.90625 m plan, K3 and
        # K4 forced on its fine brick (2,179,617 nodes); every brick of
        # main_mesh_small's plans on the tier the rule gives it
        every62 = range(len(plan_g62.bricks))
        every4 = range(len(plan_g4.bricks))
        kcases = []
        for dtype, steps, bound, mbound in ((f64, 40, 2e-13, 2e-13),
                                            (f32, 20, 1e-4, 1e-3)):
            these = [
                ("graded62", sim_g62, plan_g62, every62, None),
                ("graded62", sim_g62b, plan_g62, every62, None),
                ("graded62", sim_g62b, plan_g62, every62, "node"),
                ("graded62", sim_g62b, plan_g62, every62, "corner"),
                ("graded_q62", sim_q62, plan_q62, every62, None),
                ("graded_q62", sim_q62, plan_q62, (0,), "node"),
                ("graded4", sim_g4, plan_g4, every4, None),
                ("graded4", sim_g4b, plan_g4, every4, None),
                ("graded4", sim_g4b, plan_g4, (fine4,), "node"),
                ("graded4", sim_g4b, plan_g4, (fine4,), "corner")]
            kcases += [c + (dtype, steps, bound, mbound) for c in these]
            # main_mesh_small's bricks; their bfloat16 memory variables
            # in float32 on the fine brick's mixed elements held, as in
            # phases k3 and k4, to 5e-3 (one bfloat16 ulp is 2^-8 of a
            # value: a rounding the kernel and the plain version take
            # apart near the largest value exceeds 1e-3 of it)
            kcases += [(label, sim, plan, range(len(plan.bricks)), None,
                        dtype, steps, bound,
                        mbound if dtype == f64 else 5e-3)
                       for label, (sim, plan, _) in small.items()]
            # the LOH.1 brick phase loh1 runs K1 on (damping none)
            kcases.append(("loh1", sim_loh, plan_loh, (0,), None, dtype,
                           steps, bound, mbound))
        cases = []
        mesh_err = {}
        for label, sim, plan, bricks, tier, dtype, steps, bound, mbound \
                in kcases:
            for b in bricks:
                mod, LEN = fused_mesh.brick_step_module(
                    plan, b, sim.tables, dtype, dev, tier=tier)
                nb = plan.bricks[b].nb
                parts = random_parts(mod, LEN, nb, dtype)
                kp = [x.clone() for x in parts]
                spare = [torch.empty_like(x) for x in parts]
                pp = [x.clone() for x in parts]
                for _ in range(steps):
                    new = kernel_step(mod, kp, spare)
                    spare, kp = kp, new
                    pp = plain_step(mod, pp)
                torch.cuda.synchronize()
                r, err = rel(kp[0], pp[0])
                mem = [crel(a, c) for a, c in zip(kp[1:], pp[1:])]
                name = {None: "brick_step", "uniform": "bkt_step",
                        "node": "bkt_node_step",
                        "corner": "bkt_corner_step"}[
                    getattr(mod, "tier", None)]
                mb = (mbound if dtype == f64 or parts[1].dtype
                      == torch.bfloat16 else bound) if len(mem) else None
                cases.append({"case": label, "brick": b, "nodes": nb,
                              "axes": list(plan.bricks[b].axes),
                              "kernel": name, "forced": tier,
                              "damping": sim.tables.damping,
                              "dtype": str(dtype), "steps": steps,
                              "conv": [str(x.dtype) for x in parts[1:]],
                              "mixed": getattr(mod, "mix_M", 0),
                              "rel_err": r, "max_abs_err": err,
                              "conv_rel_err": [m[0] for m in mem],
                              "bound": bound, "conv_bound": mb})
                require(r <= bound and all(m[0] <= mb for m in mem),
                        f"k_mesh: {name} vs plain {cases[-1]}")
                require(not kp[0][:, nb:].any()
                        and not any(x[:, nb:].any() for x in kp[1:]
                                    if x.dim() == 2),
                        f"k_mesh: {name} moved the padding {cases[-1]}")
                mesh_err[name] = max(mesh_err.get(name, 0.0), err)
        emit({"phase": "k_mesh", "cases": cases, "max_abs_err": mesh_err,
              "graded4": {"elements": E4, "nodes": N4,
                          "setup_s": setup_g4_s,
                          "bricks": [{"nodes": b.nb, "axes": list(b.axes),
                                      "offsets": b.corner_offsets()}
                                     for b in plan_g4.bricks]}})

        # ---- 15. the graded main path: the CLI at 2.4 M elements -------
        # launches per step of each damping's plan, from the tier rule
        per_step = {
            d: fused_mesh.MeshPallasTables(plan_g4, sim.tables, dtype=f32,
                                           device=dev).launches_per_step()
            for d, sim in (("rayleigh", sim_g4), ("bkt", sim_g4b))}
        mesh_runs = {}
        for damping, kernels in (("rayleigh", ("brick_step",)),
                                 ("bkt", ("bkt_step",))):
            got = main_path("main_mesh", ("cuda_mesh", "cuda_mesh"), kernels,
                            edge=3.90625, tag=f"_{damping}", mesh=(E4, N4),
                            **graded(3.90625, damping=damping))
            want = {k: n * 400 for k, n in per_step[damping].items()}
            for d in ("float32", "float64"):
                ran = {k: v for k, v in got["by_type"][d].items() if v}
                require(ran == want, f"main_mesh {damping} {d}: launches "
                        f"{ran}, want bricks x steps {want}")
            mesh_runs[damping] = got
        # K3 and K4 on graded plans, and the TeraShake copy, through
        # Simulation.run in both types: route cuda_mesh, each kernel
        # launched once per step on each brick of its tier
        small_mesh = {}
        for label, (sim, plan, tiers) in small.items():
            mt = fused_mesh.MeshPallasTables(plan, sim.tables, dtype=f32,
                                             device=dev)
            require(tuple(mt.tiers) == tiers,
                    f"{label} tiers {mt.tiers}, want {tiers}")
            res = {}
            for dname in ("float32", "float64"):
                for c in counters:
                    c.launches = 0
                (Ss, _, _), smp = sim.run(device=dev, dtype=dts[dname])
                ran = {c.__name__: c.launches for c in counters
                       if c.launches}
                T = sim.params.total_steps
                want = {k: n * T for k, n in mt.launches_per_step().items()}
                require(sim.solver_path_name == "cuda_mesh",
                        f"{label} route {sim.solver_path_name}")
                require(ran == want, f"{label} {dname}: launches {ran}, "
                        f"want {want}")
                u = fused_mesh.mesh_u_global(plan, Ss, sim.mesh.nnum)
                out = smp if smp.size else u
                require(np.isfinite(out).all() and np.abs(out).max() > 0,
                        f"{label} {dname}: output not finite and non-zero")
                res[dname] = (out, ran)
            f32_rel = float(np.abs(res["float32"][0] - res["float64"][0]
                                   ).max() / np.abs(res["float64"][0]).max())
            small_mesh[label] = {
                "elements": sim.mesh.lenum, "bricks": len(plan.bricks),
                "loose": len(plan.loose_eidx), "tiers": mt.tiers,
                "reconciler": mt.reconciler, "steps": T,
                "compared": "stations" if res["float64"][0].ndim == 3
                else "displacement",
                "f32_vs_f64_rel": f32_rel,
                "launches": {d: res[d][1] for d in res}}
            require(f32_rel <= 1e-2, f"{label}: float32 vs float64 "
                    f"{f32_rel}")
        emit({"phase": "main_mesh_small", "runs": small_mesh})

        # ---- 15b. outputs: 4-D volume, plane, checkpoints, restart ---
        from hercules_tpu_torch.fixtures import add_output_keys
        from hercules_tpu_torch.io.output4d import read_4d
        from hercules_tpu_torch.io.planes import PlaneSet
        from hercules_tpu_torch.sim import NodeGather
        from hercules_tpu_torch.solver.fused_brick import pallas_u_global
        OUT_STEPS, OUT_RATE, PLANE_RATE, CK_RATE = 400, 40, 20, 200
        tap_timers = ("Solver", "Solver time loop", "Solver output taps")

        def counted(fn):
            return count_launches(counters, fn)

        def cli_run(label, paths, dname):
            """The CLI on a case: ({kernel: launches}, the timers'
            seconds in the run)."""
            before = {k: GLOBAL_TIMERS.value(k) for k in tap_timers}
            out = io.StringIO()

            def run():
                with contextlib.redirect_stdout(out):
                    return cli.main([f"--dtype={dname}", *paths])

            rc, ran = counted(run)
            with open(os.path.join(LOG, f"cli_outputs_{label}.log"),
                      "w") as f:
                f.write(out.getvalue())
            require(rc == 0, f"outputs {label}: CLI exit code {rc}")
            return ran, {k: GLOBAL_TIMERS.value(k) - before[k]
                         for k in tap_timers}

        def ck_step(path):
            with np.load(path) as z:
                return int(z["step"])

        def host_ms(fn, reps=10):
            """Median ms of fn() on the host's clock, the card synced."""
            fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(reps):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t))
            return statistics.median(ts)

        def station_rows(rundir):
            return [open(os.path.join(rundir, "stations",
                                      f"station.{i}")).read().splitlines()
                    for i in range(5)]

        # (label, write_box_case keywords, type, route, kernels, the
        # phase-main run of the same case without taps (phase, type))
        out_cases = (
            ("box_k5", dict(), "float32", "cuda_chunk", ("brick_chunk",),
             (main_launches, "float32")),
            ("soft_k6", dict(damping="bkt", layers=SOFT_LAYERS,
                             freq=1200.0 / (8 * 7.8125)),
             "float32", "cuda_bkt_chunk", ("bkt_chunk",), None),
            ("four_q_k3", four_big, "float32", "cuda_bkt_node_step",
             ("bkt_node_step",), (node_launches, "float32")),
            ("thin_k4", thin_big, "float64", "cuda_bkt_corner_step",
             ("bkt_corner_step",), (corner_by_box["2^20_thin"],
                                    "float64")),
            ("graded_q", graded(7.8125, GRADED_Q_LAYERS, damping="bkt"),
             "float32", "cuda_mesh", ("bkt_step", "bkt_node_step"), None))
        out_res = {}
        t_phase = time.perf_counter()
        for label, kw, dname, route, kernels, main_run in out_cases:
            a_dir = os.path.join(work, f"outputs_{label}_a")
            b_dir = os.path.join(work, f"outputs_{label}_b")
            paths = write_box_case(a_dir, 7.8125, OUT_STEPS, 5, **kw)
            add_output_keys(paths[1], paths[2], OUT_RATE, PLANE_RATE,
                            CK_RATE)
            # run A: 400 steps from zero, every tap on
            ran_a, sec_a = cli_run(f"{label}_a", paths, dname)
            ck_a = os.path.join(a_dir, "checkpoints")
            at = {ck_step(os.path.join(ck_a, f)): f
                  for f in ("checkpoint.out0", "checkpoint.out1")}
            require(sorted(at) == [CK_RATE, OUT_STEPS],
                    f"outputs {label}: checkpoints of steps {sorted(at)}")
            # run B: A's step-200 checkpoint as checkpoint.in, a copy of
            # the case
            shutil.copytree(os.path.join(a_dir, "in"),
                            os.path.join(b_dir, "in"))
            shutil.copy(paths[0], b_dir)
            os.makedirs(os.path.join(b_dir, "checkpoints"))
            shutil.copy(os.path.join(ck_a, at[CK_RATE]),
                        os.path.join(b_dir, "checkpoints",
                                     "checkpoint.in"))
            b_paths = [os.path.join(b_dir, os.path.relpath(x, a_dir))
                       for x in paths]
            ran_b, sec_b = cli_run(f"{label}_b", b_paths, dname)
            # the straight run to the last 4-D frame's step, no taps
            sim_c = Simulation.setup(paths[1], paths[2], paths[0])
            last = (OUT_STEPS - 1) // OUT_RATE * OUT_RATE
            loop0 = GLOBAL_TIMERS.value("Solver time loop")
            (state_c, _), ran_c = counted(lambda: sim_c.run(
                device=dev, dtype=dts[dname], total_steps=last,
                rundir=a_dir))
            loop_c = GLOBAL_TIMERS.value("Solver time loop") - loop0
            require(sim_c.solver_path_name == route,
                    f"outputs {label}: route {sim_c.solver_path_name}")
            for ran in (ran_a, ran_b, ran_c):
                require(all(ran.get(k, 0) > 0 for k in kernels),
                        f"outputs {label}: a kernel of the path never "
                        f"ran: {ran}")
            # the launches: a chunk kernel once per tap interval, a
            # step kernel (per brick) once per step
            chunk = np.gcd.reduce([OUT_RATE, PLANE_RATE, CK_RATE])
            plan_c = build_plan(sim_c.mesh)
            if route == "cuda_mesh":
                per_step = fused_mesh.MeshPallasTables(
                    plan_c, sim_c.tables, dtype=dts[dname],
                    device=dev).launches_per_step()
                want_a = {k: n * OUT_STEPS for k, n in per_step.items()}
                want_b = {k: n * CK_RATE for k, n in per_step.items()}
            elif route.endswith("chunk"):
                want_a = {kernels[0]: OUT_STEPS // chunk}
                want_b = {kernels[0]: CK_RATE // chunk}
            else:
                # the step route: SourceSample once a step (the step's
                # sources, the next step's samples), and once more a
                # chunk (its first step's samples)
                want_a = {kernels[0]: OUT_STEPS,
                          "SourceSample": OUT_STEPS + OUT_STEPS // chunk}
                want_b = {kernels[0]: CK_RATE,
                          "SourceSample": CK_RATE + CK_RATE // chunk}
            require(ran_a == want_a and ran_b == want_b,
                    f"outputs {label}: launches A {ran_a} B {ran_b}, "
                    f"want {want_a}, {want_b}")
            # B's station rows are A's from step 200 on; B's 4-D frames
            # after step 200 are A's, bit for bit (earlier ones holes)
            rows_a, rows_b = station_rows(a_dir), station_rows(b_dir)
            require(all(rb[0] == "" and rb[1:] == ra[1 + CK_RATE:]
                        and len(ra) == 1 + OUT_STEPS
                        for ra, rb in zip(rows_a, rows_b)),
                    f"outputs {label}: resumed station rows differ")
            frames = {}
            k0 = CK_RATE // OUT_RATE + 1
            for f in ("disp.h4d", "vel.h4d"):
                _, fa = read_4d(os.path.join(a_dir, f))
                _, fb = read_4d(os.path.join(b_dir, f))
                require(np.array_equal(fa[k0:], fb[k0:])
                        and not fb[:k0].any() and np.isfinite(fa).all()
                        and np.abs(fa[-1]).max() > 0,
                        f"outputs {label}: resumed {f} frames differ")
                frames[f] = fa
            # the step-400 checkpoints of A and B hold one state
            with np.load(os.path.join(ck_a, at[OUT_STEPS])) as za, \
                    np.load(os.path.join(b_dir, "checkpoints",
                                         "checkpoint.out0")) as zb:
                require(int(zb["step"]) == OUT_STEPS
                        and za.files == zb.files
                        and all(np.array_equal(za[k], zb[k])
                                for k in za.files),
                        f"outputs {label}: step-400 checkpoints differ")
                ck_parts = {k: [list(za[k].shape), str(za[k].dtype)]
                            for k in za.files if za[k].ndim}
            # the last frames are the straight run's state; the plane
            # records the phi-weighted corner sums of the frames
            N_c = sim_c.mesh.nnum
            if route == "cuda_mesh":
                Ss = state_c[0]
                u = fused_mesh.mesh_u_global(plan_c, [S[0:3] for S in Ss],
                                             N_c)
                up = fused_mesh.mesh_u_global(plan_c,
                                              [S[3:6] for S in Ss], N_c)
            else:
                u = pallas_u_global(plan_c, state_c[0], N_c)
                up = pallas_u_global(plan_c, state_c[1], N_c)
            vel = (u - up) / sim_c.params.delta_t
            # one tap's pieces on the host's clock, median of 10:
            # plan.gnid_cat's copy to the card (once per run), a global
            # [N, 3] field (scatter on the card and its copy to the
            # host), that copy alone, and a plane-only record's corner
            # gather
            rows = ([S[0:3] for S in state_c[0]] if route == "cuda_mesh"
                    else state_c[0])
            gidx = torch.as_tensor(plan_c.gnid_cat, device=dev)
            field = torch.as_tensor(u, device=dev)
            ps = PlaneSet(sim_c.mesh, sim_c.params,
                          os.path.join(work, f"outputs_{label}_tables"))
            ps.close()
            gather = NodeGather(plan_c, ps.all_nodes, N_c)
            require(np.array_equal(gather(rows), u[ps.all_nodes]),
                    f"outputs {label}: plane gather vs global field")
            copies_ms = {
                "gnid_to_card": host_ms(lambda: torch.as_tensor(
                    plan_c.gnid_cat, device=dev)),
                "global_field": host_ms(
                    lambda: fused_mesh.mesh_u_global(plan_c, rows, N_c, gidx)
                    if route == "cuda_mesh"
                    else pallas_u_global(plan_c, rows, N_c, gidx)),
                "field_to_host": host_ms(lambda: field.cpu().numpy()),
                "plane_gather": host_ms(lambda: gather(rows))}
            require(np.array_equal(frames["disp.h4d"][-1],
                                   u.astype(np.float64))
                    and np.array_equal(frames["vel.h4d"][-1],
                                       vel.astype(np.float64)),
                    f"outputs {label}: last frames are not the state of "
                    f"the straight run")
            recs = np.fromfile(os.path.join(a_dir, "planes",
                                            "planedisplacements.0"))
            recs = recs.reshape(OUT_STEPS // PLANE_RATE, -1, 3)
            plane_err = 0.0
            for k, fr in enumerate(frames["disp.h4d"]):
                want = np.einsum("mk,mkc->mc", ps.all_phi,
                                 fr[ps.all_nodes])
                plane_err = max(plane_err, float(
                    np.abs(recs[k * OUT_RATE // PLANE_RATE] - want).max()
                    / max(np.abs(want).max(), 1e-300)))
            require(plane_err <= 1e-12 and np.abs(recs).max() > 0,
                    f"outputs {label}: plane records vs frames "
                    f"{plane_err}")
            with open(os.path.join(a_dir, "output-stats.txt")) as f:
                io_s = float(re.search(r"io wall seconds\s*=\s*(\S+)",
                                       f.read()).group(1))
            out_res[label] = {
                "elements": sim_c.mesh.lenum, "nodes": N_c,
                "dtype": dname, "route": route,
                "launches": {"a": ran_a, "b": ran_b, "straight": ran_c},
                "with_taps_s": sec_a, "resumed_s": sec_b,
                "straight_loop_s": loop_c, "straight_steps": last,
                "loop_ms_per_step": {
                    "with_taps": 1e3 * sec_a["Solver time loop"]
                    / OUT_STEPS,
                    "straight": 1e3 * loop_c / last},
                "main_without_taps_s": None if main_run is None
                else main_run[0]["seconds"][main_run[1]],
                "disp_io_seconds": io_s, "tap_pieces_ms": copies_ms,
                "checkpoint_parts": ck_parts,
                "plane_rel_err": plane_err}
        emit({"phase": "outputs", "steps": OUT_STEPS,
              "output_rate": OUT_RATE, "planes_print_rate": PLANE_RATE,
              "checkpointing_rate": CK_RATE, "card": roofline.card(),
              "seconds": time.perf_counter() - t_phase, "cases": out_res})

        # ---- 16. accuracy: the CUDA mesh route against the brick solver
        def u_state(seed):
            """A random global (u, u-) pair, u ~ 1e-3 N(0, 1)."""
            r = np.random.default_rng(seed)
            u = 1e-3 * r.standard_normal((N4, 3))
            return u, u - 1e-5 * r.standard_normal((N4, 3))

        acc = {}
        st4 = sim_g4.stations
        for damping, sim in (("rayleigh", sim_g4), ("bkt", sim_g4b)):
            u0, up0 = u_state(7)
            g = torch.as_tensor(plan_g4.gnid_cat, device=dev)
            ub = torch.as_tensor(u0, dtype=f64, device=dev)[g].T
            upb = torch.as_tensor(up0, dtype=f64, device=dev)[g].T
            conv0 = brickstep.init_brick_state(
                brickstep.brick_meta(plan_g4), plan_g4.total_nb,
                sim.tables.damping, f64, dev)[2]
            run = dict(st_nodes=st4.nodes, st_phi=st4.phi, dtype=f64,
                       device=dev)
            args = (plan_g4, sim.tables, sim.src_ids, sim.src_forces, 40,
                    sim.params.delta_t)
            (ub1, _, _), s_b = brickstep.run_brick_solver(
                *args, state=(ub.contiguous(), upb.contiguous(), conv0),
                **run)
            u_b = brickstep.brick_u_global(plan_g4, ub1, N4)
            res = {}
            state = mesh_state_from_jax((u0, up0), plan_g4)
            for rec in ("plane", "index"):
                mt = fused_mesh.MeshPallasTables(
                    plan_g4, sim.tables, sim.src_ids, st4.nodes, st4.phi,
                    f64, dev, reconciler=rec)
                require(mt.reconciler == rec, f"reconciler {mt.reconciler}")
                # twice: a run repeats its bits
                for _ in range(2):
                    (Ss, _, _), s_m = fused_mesh.run_mesh(
                        mt, sim.src_forces, 40, sim.params.delta_t,
                        state=state)
                    res.setdefault(rec, []).append(
                        ([S.clone() for S in Ss], s_m))
            torch.cuda.synchronize()
            scale, sscale = np.abs(u_b).max(), np.abs(s_b).max()
            require(scale > 0 and sscale > 0, "accuracy_mesh: zero field")
            errs = {}
            for rec in ("plane", "index"):
                (Ss, s_m), (Ss2, s_m2) = res[rec]
                u_m = fused_mesh.mesh_u_global(plan_g4, Ss, N4)
                errs[rec] = {
                    "vs_bricks_rel": float(np.abs(u_m - u_b).max() / scale),
                    "samples_vs_bricks_rel":
                        float(np.abs(s_m - s_b).max() / sscale),
                    "bit_identical_repeat": all(
                        torch.equal(a, b) for a, b in zip(Ss, Ss2))
                    and np.array_equal(s_m, s_m2)}
            u_p = fused_mesh.mesh_u_global(plan_g4, res["plane"][0][0], N4)
            u_i = fused_mesh.mesh_u_global(plan_g4, res["index"][0][0], N4)
            errs["plane_vs_index_rel"] = float(np.abs(u_p - u_i).max()
                                               / scale)
            acc[damping] = errs
            require(all(errs[r]["vs_bricks_rel"] <= 5e-12
                        and errs[r]["samples_vs_bricks_rel"] <= 5e-12
                        for r in ("plane", "index"))
                    and errs["plane_vs_index_rel"] <= 5e-12,
                    f"accuracy_mesh {damping}: {errs}")
            require(all(errs[r]["bit_identical_repeat"]
                        for r in ("plane", "index")),
                    f"accuracy_mesh {damping}: a repeated run differs")
        emit({"phase": "accuracy_mesh", "elements": E4, "steps": 40,
              "dtype": str(f64), "bound": 5e-12, "results": acc})

        # ---- 17. K7 against its plain version ------------------------
        shape7 = (8, hbm_ceiling.LEN)
        a7 = torch.as_tensor(rng.standard_normal(shape7), dtype=f32,
                             device=dev)
        b7 = torch.as_tensor(rng.standard_normal(shape7), dtype=f32,
                             device=dev)
        want = stream_add_plain(a7, b7)
        got = stream_add(a7, b7)
        s7 = a7.clone()
        stream_add(s7, b7, out=s7)
        torch.cuda.synchronize()
        same = {"bit_identical": torch.equal(got, want),
                "aliased_bit_identical": torch.equal(s7, want)}
        err7 = max((got - want).abs().max().item(),
                   (s7 - want).abs().max().item())
        emit({"phase": "k7", "shape": list(shape7), "dtype": str(f32),
              **same, "max_abs_err": err7, "launches": stream_add.launches})
        require(all(same.values()), f"K7 vs torch.add: {same}")
        kern["stream_add_err"] = err7

        # ---- 18. K7's main path: the streaming-ceiling probe ---------
        stream_add.launches = 0
        ceiling = hbm_ceiling.main()
        k7_launches = stream_add.launches
        emit({"phase": "hbm_ceiling", **ceiling, "launches": k7_launches})
        require(k7_launches > 0, "the probe never launched K7")
        require(len(ceiling["legs"]) == 4
                and all(leg["GBps"] > 0 for leg in ceiling["legs"].values()),
                f"hbm_ceiling legs {ceiling['legs']}")
        ceiling_GBps = ceiling["legs"]["stream_add aliased"]["GBps"]
        t_k7 = ceiling["legs"]["stream_add aliased"]["ms_per_iteration"]
        # the library call's legs bracket K7's: the faster of the two
        t_add = min(ceiling["legs"][k]["ms_per_iteration"]
                    for k in ("torch.add", "torch.add again"))

        # ---- 19. timings, each kernel at its main path's shape and type
        card = roofline.card()
        STEPS = 400             # the main paths' steps (K5/K6: one launch)

        def twice(kernel, plain, reps=30, preps=10):
            """(kernel ms, plain ms), each timed twice in turns (kernel,
            plain, plain, kernel); the lower of each pair."""
            k1 = timed(kernel, reps, 5)
            p1 = timed(plain, preps, 2)
            p2 = timed(plain, preps, 2)
            k2 = timed(kernel, reps, 5)
            return [k1, k2], [p1, p2]

        # per (kernel, type): ms pair, plain ms pair, KernelCost
        T, P, C = {}, {}, {}
        lone_ms = {}

        # K1 and K5 on the 2^20 box
        for dname in ("float64", "float32"):
            pt = tables(sim_b, plan_b, dts[dname])
            S = random_state(pt)
            spare = torch.empty_like(S)
            ops = (pt.K, pt.offs, pt.step.ops)
            key = ("brick_step", dname)
            T[key], P[key] = twice(lambda: brick_step(S, *ops, out=spare),
                                   lambda: brick_step_plain(S, *ops))
            C[key] = roofline.route_costs(pt, sim_b.mesh.lenum)["brick_step"]
        inc1 = source_increments(pt, sim_b.src_forces, dt2_b, 0, 1)
        io1 = SourceSample(pt.src_pos, pt.st_pos, pt.st_phi)
        smp1 = torch.empty((1, pt.n_st, 3), dtype=pt.dtype, device=dev)

        # a step of the step route: K1, then one SourceSample launch
        # (the step's source add and the next step's samples)
        def k1_route_step():
            Sn = brick_step(S, *ops, out=spare)
            io1(Sn, inc1[0], smp1[0])

        route_ms = {"k1_route_step": timed(k1_route_step, 30, 5)}
        lone_ms["k1_route_step"] = lone(k1_route_step)
        srcf = source_increments(pt, sim_b.src_forces, dt2_b, 0, STEPS)
        require(srcf.shape[0] == STEPS, f"{srcf.shape[0]} source steps")
        srcf20 = srcf[:20].contiguous()
        key = ("brick_chunk", "float32")
        T[key] = [timed(lambda: brick_chunk(S, spare, *ops, srcf, pt.src_pos,
                                            pt.st_pos, pt.st_phi), 3, 1)
                  / STEPS]
        P[key] = [timed(lambda: brick_chunk_plain(S, *ops, srcf20,
                                                  pt.src_pos, pt.st_pos,
                                                  pt.st_phi), 3, 1) / 20]
        C[key] = roofline.route_costs(pt, sim_b.mesh.lenum,
                                      chunk=STEPS)["brick_chunk"]

        # K2 and K6 on the 2^20 BKT box (6 rows of memory variables)
        for dname in ("float64", "float32"):
            ptb = tables(sim_bb, plan_bb, dts[dname])
            Sb, cb = random_bkt_state(ptb)
            spb, cspb = torch.empty_like(Sb), torch.empty_like(cb)
            bargs = (ptb.K, ptb.offs, ptb.step.scales, ptb.step.rec)
            key = ("bkt_step", dname)
            T[key], P[key] = twice(
                lambda: bkt_step(Sb, cb, *bargs, out=spb, conv_out=cspb),
                lambda: bkt_step_plain(Sb, cb, *bargs))
            C[key] = roofline.route_costs(ptb, sim_bb.mesh.lenum)["bkt_step"]
        inc1b = source_increments(ptb, sim_bb.src_forces, dt2_bb, 0, 1)
        io1b = SourceSample(ptb.src_pos, ptb.st_pos, ptb.st_phi)
        smp1b = torch.empty((1, ptb.n_st, 3), dtype=ptb.dtype, device=dev)

        def k2_route_step():
            Sn, _ = bkt_step(Sb, cb, *bargs, out=spb, conv_out=cspb)
            io1b(Sn, inc1b[0], smp1b[0])

        route_ms["k2_route_step"] = timed(k2_route_step, 30, 5)
        lone_ms["k2_route_step"] = lone(k2_route_step)
        srcfb = source_increments(ptb, sim_bb.src_forces, dt2_bb, 0, STEPS)
        require(srcfb.shape[0] == STEPS, f"{srcfb.shape[0]} source steps")
        key = ("bkt_chunk", "float32")
        T[key] = [timed(lambda: bkt_chunk(Sb, spb, cb, cspb, *bargs, srcfb,
                                          ptb.src_pos, ptb.st_pos,
                                          ptb.st_phi), 3, 1)
                  / STEPS]
        P[key] = [timed(lambda: bkt_chunk_plain(
            Sb, cb, *bargs, srcfb[:20].contiguous(), ptb.src_pos, ptb.st_pos,
            ptb.st_phi), 3, 1) / 20]
        C[key] = roofline.route_costs(ptb, sim_bb.mesh.lenum,
                                      chunk=STEPS)["bkt_chunk"]
        # beside them: the soft box at 2^20 elements (12 rows of
        # bfloat16 memory variables, bulk attenuation on)
        pts = tables(sim_bs, plan_bs, f32)
        require(pts.step.conv_dtype == torch.bfloat16, "soft conv type")
        Ss, cs = random_bkt_state(pts)
        sps, csps = torch.empty_like(Ss), torch.empty_like(cs)
        sargs = (pts.K, pts.offs, pts.step.scales, pts.step.rec)
        srcfs = source_increments(pts, sim_bs.src_forces,
                                  sim_bs.params.delta_t ** 2, 0, 20)
        soft_ms = {
            "bkt_step": timed(lambda: bkt_step(Ss, cs, *sargs, out=sps,
                                               conv_out=csps),
                              30, 5),
            "bkt_step_plain": timed(lambda: bkt_step_plain(Ss, cs, *sargs),
                                    10, 2),
            "bkt_chunk": timed(lambda: bkt_chunk(
                Ss, sps, cs, csps, *sargs, srcfs, pts.src_pos, pts.st_pos,
                pts.st_phi), 10, 2) / 20}

        # K3 on the four-layer box at 2^20 elements (49,533 mixed
        # elements), both types of its main path
        for dname in ("float32", "float64"):
            ptn = tables(sim_4b, plan_4b, dts[dname])
            st_n = random_bktq_state(ptn)
            sp_n = [torch.empty_like(x) for x in st_n]
            nargs = (ptn.K, ptn.offs, ptn.step.tab)
            outs = dict(zip(("out", "conv_out", "conv_mix_out"), sp_n))
            key = ("bkt_node_step", dname)
            T[key], P[key] = twice(
                lambda: bkt_node_step(st_n[0], st_n[1], *nargs,
                                      mix=ptn.step.mix, conv_mix=st_n[2],
                                      **outs),
                lambda: bkt_node_step_plain(st_n[0], st_n[1], *nargs,
                                            ptn.step.mix, st_n[2]))
            C[key] = roofline.route_costs(
                ptn, sim_4b.mesh.lenum)["bkt_node_step"]
            if dname == "float32":
                inc1n = source_increments(ptn, sim_4b.src_forces,
                                          sim_4b.params.delta_t ** 2, 0, 1)
                io1n = SourceSample(ptn.src_pos, ptn.st_pos, ptn.st_phi)
                smp1n = torch.empty((1, ptn.n_st, 3), dtype=ptn.dtype,
                                    device=dev)

                def k3_route_step():
                    S1 = ptn.step(*st_n, **outs)[0]
                    io1n(S1, inc1n[0], smp1n[0])

                route_ms["k3_route_step"] = timed(k3_route_step, 30, 5)
                lone_ms["k3_route_step"] = lone(k3_route_step)
                mixed = ptn.step.mix_M

        # K4 on both boxes of its main path, both types: the four-layer
        # box at 62.5 m (2048 elements) and the thin-layer box at 2^20;
        # and the four-layer box forced at 2^20 in float32, for
        # comparison with earlier runs.  K4 alone on the 2048-element
        # box (a few microseconds of work) is timed alone and per host
        # call too.
        k4_small = {}
        for label, sim, plan, dname, tier in (
                ("", sim_4q, plan_4q, "float32", None),
                ("", sim_4q, plan_4q, "float64", None),
                ("_2^20_thin", sim_th, plan_th, "float32", None),
                ("_2^20_thin", sim_th, plan_th, "float64", None),
                ("_2^20_forced", sim_4b, plan_4b, "float32", "corner")):
            ptc = tables(sim, plan, dts[dname], bkt_tier=tier)
            require(ptc.bkt_tier == "corner", f"K4 timing tier {ptc.bkt_tier}")
            Sc0, cc0 = random_bktq_state(ptc)
            spc, cspc = torch.empty_like(Sc0), torch.empty_like(cc0)
            cargs = (ptc.K, ptc.offs, ptc.step.tab)
            key = ("bkt_corner_step" + label, dname)
            T[key], P[key] = twice(
                lambda: bkt_corner_step(Sc0, cc0, *cargs, out=spc,
                                        conv_out=cspc),
                lambda: bkt_corner_step_plain(Sc0, cc0, *cargs))
            C[key] = roofline.route_costs(
                ptc, sim.mesh.lenum)["bkt_corner_step"]
            if not label:
                k4_small[dname] = (
                    lambda Sc0=Sc0, cc0=cc0, cargs=cargs, spc=spc,
                    cspc=cspc: bkt_corner_step(Sc0, cc0, *cargs, out=spc,
                                               conv_out=cspc))
                lone_ms[f"bkt_corner_step 2048 {dname}"] = lone(
                    k4_small[dname])

        # the mesh route at 3.90625 m (2,424,832 elements, 3 bricks with
        # reordered axes): its step back to back and alone, each brick's
        # kernel by device time (a CUDA graph of its launches: no host
        # work between them), and K1-K4 at the fine brick's shape
        def fine_of(plan):
            """(index, elements) of the plan's largest brick."""
            b = int(np.argmax([x.nb for x in plan.bricks]))
            br = plan.bricks[b]
            return b, int(plan.evalid_cat[br.off:br.off + br.nb].sum())

        def time_brick(plan, b, elems, sim, dname):
            """Brick b's step module (the rule's tier) against its plain
            version, into T, P and C under (kernel + "_mesh", dname);
            returns the kernel's name."""
            mod, LEN = fused_mesh.brick_step_module(plan, b, sim.tables,
                                                    dts[dname], dev)
            parts = random_parts(mod, LEN, plan.bricks[b].nb, dts[dname])
            sp = [torch.empty_like(x) for x in parts]
            cost = roofline.step_cost(mod, LEN, elems, dts[dname])
            key = (f"{cost.name}_mesh", dname)
            T[key], P[key] = twice(lambda: kernel_step(mod, parts, sp),
                                   lambda: plain_step(mod, parts))
            C[key] = cost
            return cost.name

        mesh_route = {}
        _, fine_elems = fine_of(plan_g4)
        for damping, sim in (("rayleigh", sim_g4), ("bkt", sim_g4b)):
            for dname in ("float32", "float64"):
                srcf1 = torch.as_tensor(
                    sim.src_forces[0] * sim.params.delta_t ** 2,
                    dtype=dts[dname], device=dev)
                steps, runs = {}, {}
                for rec in ("plane", "index"):
                    mt = fused_mesh.MeshPallasTables(
                        plan_g4, sim.tables, sim.src_ids, st4.nodes,
                        st4.phi, dts[dname], dev, reconciler=rec)
                    state = fused_mesh.fit_mesh_state(
                        mt, mesh_state_from_jax(u_state(11), plan_g4))
                    spare = fused_mesh.init_mesh_state(mt)
                    step = fused_mesh.make_mesh_step(mt)
                    steps[rec] = (lambda step=step, state=state, spare=spare:
                                  step(state, spare, srcf1))
                # each reconciler's step in turns: plane, index, index,
                # plane; back to back and alone
                for rec in ("plane", "index", "index", "plane"):
                    runs.setdefault(rec, []).append(
                        (timed(steps[rec], 30, 5), lone(steps[rec], 30)))
                dev_ms = []
                for b, mod in enumerate(mt.steps):
                    parts = [state[0][b], *state[1][b]]
                    sp = [spare[0][b], *spare[1][b]]
                    dev_ms.append(graph_ms(
                        lambda mod=mod, parts=parts, sp=sp:
                        kernel_step(mod, parts, sp)))
                for rec in ("plane", "index"):
                    back = min(b_ for b_, _ in runs[rec])
                    alone = min(a_ for _, a_ in runs[rec])
                    mesh_route[f"{damping} {dname} {rec}"] = {
                        "launches_per_step": mt.launches_per_step(),
                        "kernel_device_ms": dev_ms,
                        "kernel_device_sum_ms": sum(dev_ms),
                        "route_ms_runs": [b_ for b_, _ in runs[rec]],
                        "route_lone_ms_runs": [a_ for _, a_ in runs[rec]],
                        "route_ms": back, "route_lone_ms": alone,
                        "host_ms": alone - sum(dev_ms),
                        "host_share": 1 - sum(dev_ms) / alone,
                        "element_updates_per_s": E4 / (back * 1e-3)}
                # K1 (Rayleigh) or K2 (BKT) at the fine brick
                time_brick(plan_g4, fine4, fine_elems, sim, dname)
        # K3 and K4 at the fine brick of the plans main_mesh_small runs
        # them on (GRADED_Q_LAYERS and GRADED_THIN_LAYERS at 7.8125 m,
        # the tier by the rule, mixed elements included), both types
        for label, kname in (("graded_q_7.8125", "bkt_node_step"),
                             ("graded_thin_7.8125", "bkt_corner_step")):
            sim, plan, _ = small[label]
            b, elems = fine_of(plan)
            for dname in ("float32", "float64"):
                got = time_brick(plan, b, elems, sim, dname)
                require(got == kname, f"{label} fine brick runs {got}")

        # SourceSample at B1's shapes, both types: one launch (a step's
        # add and samples) against the torch operations it replaced
        for dname in ("float32", "float64"):
            S_ss, io_ss, inc_ss, smp_ss = b1_source_sample(dts[dname], dev)
            key = ("SourceSample", dname)
            T[key], P[key] = twice(
                lambda: io_ss(S_ss, inc_ss[0], smp_ss[0]),
                lambda: source_sample_plain(S_ss, inc_ss[0], io_ss.src_pos,
                                            smp_ss[0], io_ss.st_pos,
                                            io_ss.st_phi))
            C[key] = roofline.source_sample_cost(io_ss.L, io_ss._src[3],
                                                 io_ss.ns, dts[dname])
            lone_ms[f"SourceSample {dname}"] = lone(
                lambda: io_ss(S_ss, inc_ss[0], smp_ss[0]))

        # K7: the probe's legs; lone calls against torch.add
        key = ("stream_add", "float32")
        T[key], P[key] = [t_k7], [t_add]
        C[key] = roofline.kernel_cost("stream_add", hbm_ceiling.LEN, 0)
        for rnd in ("", "_again"):
            lone_ms["torch.add" + rnd] = lone(
                lambda: torch.add(a7, b7, out=a7))
            lone_ms["stream_add" + rnd] = lone(
                lambda: stream_add(a7, b7, out=a7))
        # host microseconds per call on [8, 1024] (a kernel of a few us,
        # so the host sets the pace): the wall clock over 20,000 calls
        xs, ys = torch.ones((8, 1024), device=dev), torch.ones((8, 1024),
                                                               device=dev)

        def host_us(fn, n=20000):
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            return (t1 - t0) / n * 1e6

        host_us_per_call = {}
        for rnd in ("", " again"):
            host_us_per_call["torch.add" + rnd] = host_us(
                lambda: torch.add(xs, ys, out=xs))
            host_us_per_call["stream_add" + rnd] = host_us(
                lambda: stream_add(xs, ys, out=xs))
        for dname, fn in k4_small.items():
            host_us_per_call[f"bkt_corner_step 2048 {dname}"] = host_us(
                fn, n=5000)

        # each kernel's launches on its own main path, by type
        own = {"brick_step": main_launches, "brick_chunk": main_launches,
               "SourceSample": main_launches,
               "bkt_step": bkt_launches, "bkt_chunk": bkt_launches,
               "bkt_node_step": node_launches,
               "bkt_corner_step": corner_launches}
        launches = {k: {d: v["by_type"][d][k] for d in dts}
                    for k, v in own.items()}
        launches["stream_add"] = {"float32": k7_launches, "float64": 0}
        # and on the graded path (main_mesh, main_mesh_small), on bricks
        # of many shapes: they count in each kernel's total, and in its
        # time lost at the fine brick timed (main_mesh's for K1 and K2,
        # main_mesh_small's Q variants' for K3 and K4: the _mesh entries
        # below)
        mesh_launches = {k: {d: sum(r["by_type"][d].get(k, 0)
                                    for r in mesh_runs.values())
                             + sum(r["launches"][d].get(k, 0)
                                   for r in small_mesh.values())
                             for d in dts} for k in launches}
        total_launches = {k: sum(launches[k].values())
                          + sum(mesh_launches[k].values())
                          for k in launches}
        # and K1's on the LOH.1 gate's cuda_mesh run (phase loh1) and on
        # the item-7 phases' mesh-route runs
        total_launches["brick_step"] += loh1_launches + sum(
            item7_launches.values())
        # and K1's, K2's and K4's on the slab fragments (phase multigpu)
        # and on the graded paths' brick fragments (multigpu_graded)
        # and in the child processes of phase multiprocess, and K1's,
        # K2's and K5's in phase tools (the timing tools, the dry run)
        for k, n in (list(mc_launches.items()) + list(mcg_launches.items())
                     + list(mp_launches.items())
                     + list(tools_launches.items())):
            total_launches[k] += n
        # K4's launches on each box of its main path (the forced box:
        # none)
        box_launches = {(f"bkt_corner_step{lb}", d): k4_by_type[b][d]
                        for lb, b in (("", "2048"),
                                      ("_2^20_thin", "2^20_thin"))
                        for d in dts}
        # K1 and K2 at the fine brick of the 2.4 M-element plan: one
        # launch per step of main_mesh; K3 and K4 at the fine brick of
        # main_mesh_small's Q variants, the only brick on their tier
        for k, damping in (("brick_step", "rayleigh"),
                           ("bkt_step", "bkt")):
            for d in dts:
                box_launches[(f"{k}_mesh", d)] = \
                    mesh_runs[damping]["by_type"][d][k] // len(plan_g4.bricks)
        for k, label in (("bkt_node_step", "graded_q_7.8125"),
                         ("bkt_corner_step", "graded_thin_7.8125")):
            for d in dts:
                box_launches[(f"{k}_mesh", d)] = \
                    small_mesh[label]["launches"][d][k]
        per_launch = {"brick_chunk": STEPS, "bkt_chunk": STEPS}
        entries = {}
        for (k, d), c in C.items():
            t = min(T[(k, d)])
            n = box_launches.get((k, d), launches[k][d] if k in launches
                                 else 0)
            entries[f"{k} {d}"] = {
                "ms": t, "ms_runs": T[(k, d)], "plain_ms": min(P[(k, d)]),
                "bytes": c.bytes, "moved": c.moved, "flop": c.flop,
                "bound_ms": c.bound_ms, "bound_by": c.bound_by,
                "share_of_bound": c.bound_ms / t,
                "moved_GBps": c.moved / (t * 1e-3) / 1e9,
                "share_of_ceiling": c.moved / (t * 1e-3) / 1e9 / ceiling_GBps,
                "launches": n,
                "steps_per_launch": per_launch.get(k, 1),
                "time_lost_ms": n * per_launch.get(k, 1) * (t - c.bound_ms)}
        lost = {}
        for e, v in entries.items():
            k = e.split(" ")[0].split("_2^20")[0].removesuffix("_mesh")
            lost[k] = lost.get(k, 0.0) + v["time_lost_ms"]
        # the row of each kernel: the type of its main path's launches
        # (float64 for the K1 and K2 step routes, float32 otherwise; K3
        # and K4 run both, their float64 entries stand beside the row),
        # at its main path's shape (K4: the thin-layer box at 2^20, its
        # 2048-element entries beside it)
        row = {"brick_step": "brick_step float64",
               "bkt_step": "bkt_step float64",
               "bkt_corner_step": "bkt_corner_step_2^20_thin float32"}
        roof = {k: {**entries[row.get(k, f"{k} float32")],
                    "launches": total_launches[k],
                    "library_ms": t_add if k == "stream_add" else None}
                for k in launches}
        # the routing rule of fused_brick.chunk_applies: K5 carries
        # float32 elastic runs while its step beats the K1 route's
        k5_vs_k1 = {"brick_chunk float32": min(T[("brick_chunk", "float32")]),
                    "k1_route_step float32": route_ms["k1_route_step"]}
        emit({"phase": "timing", "card": card, "steps": STEPS,
              "entries": entries, "time_lost_ms": lost,
              "route_ms_per_step": route_ms, "lone_call_ms": lone_ms,
              "host_us_per_call": host_us_per_call,
              "soft_box_ms": soft_ms, "mixed_elements": mixed,
              # the routing rule of fused_brick.chunk_applies: K6 carries
              # float32 uniform-Q BKT while its step beats the K2 route's
              "k6_step_vs_k2_route_step_ms": {
                  "bkt_chunk float32": min(T[("bkt_chunk", "float32")]),
                  "k2_route_step float32": route_ms["k2_route_step"]},
              "k5_step_vs_k1_route_step_ms": k5_vs_k1,
              "stream_ceiling_GBps": ceiling_GBps,
              "mesh_route": mesh_route, "mesh_launches": mesh_launches,
              "total_launches": total_launches,
              "element_updates_per_s": {
                  k: sim_b.mesh.lenum / (v * 1e-3)
                  for k, v in route_ms.items()}})

        # the TPU kernel each one replaces, and its CUDA source
        ports = (
            ("brick_step", "brick_step.cu",
             "hercules_tpu/solver/pallas_brick.py:568"),
            ("brick_chunk", "brick_chunk.cu",
             "hercules_tpu/solver/pallas_brick.py:2924"),
            ("bkt_step", "bkt_step.cu",
             "hercules_tpu/solver/pallas_brick.py:1389"),
            ("bkt_chunk", "bkt_chunk.cu",
             "hercules_tpu/solver/pallas_brick.py:1789"),
            ("bkt_node_step", "bkt_node.cu",
             "hercules_tpu/solver/pallas_brick.py:2153"),
            ("bkt_corner_step", "bkt_corner.cu",
             "hercules_tpu/solver/pallas_brick.py:1216"),
            ("stream_add", "stream_add.cu",
             "hercules_tpu/tools/hbm_ceiling.py:75"),
            ("SourceSample", "source_sample.cu",
             "hercules_tpu/solver/pallas_brick.py:3435"))
        kernels = [
            {"name": name, "route": "cuda",
             "source": f"hercules_tpu_torch/csrc/{src}",
             "replaces": replaces, "launches": roof[name]["launches"],
             "max_abs_err": kern[f"{name}_err"],
             **{k: roof[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}}
            for name, src, replaces in ports]
        require(all(k["launches"] > 0 for k in kernels),
                f"a kernel never ran on its main path: {launches}")
        loaded = sorted(m for m in sys.modules
                        if m in ("jax", "hercules_tpu")
                        or m.startswith(("jax.", "hercules_tpu.")))
        require(not loaded, f"modules of jax or hercules_tpu loaded: "
                            f"{loaded[:10]}")
        print(json.dumps({"kernels": kernels}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
