#!/usr/bin/env python3
"""Smoke test of lbm_tpu_torch on one NVIDIA GPU (H100 class, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints
no result line):
  1. a CUDA card is present; print its name and power limit, nvcc's
     version and torch's;
  2. build the CUDA kernels from kernels/csrc with nvcc and print the
     build time and ptxas's registers, spills and stack frames per kernel
     instance: the 36 fp32 collide-stream instances (each branch with and
     without the z planes' code) as BASE_PTXAS has them, the BGK instance
     in fp32 and bf16, with and without z planes, at most 80 registers
     with no spill and no stack frame, three blocks an SM; the fp32 launch
     over the fluid cells (collide_stream_list_kernel, collide_stream_list
     .cu, 18 instances, and the two shard units' 28) as LIST_PTXAS and
     HALO_LIST_PTXAS have them, 768 threads an SM;
  3. hold each kernel against its plain PyTorch version on the card
     (the scalar and thermal checks of 3b and the K1d checks of 3e run
     in a process of their own beside the others; every timing of phase
     3 comes after all of them) (f
     at rtol 3e-6, atol 1e-7; velsum at 1e-5 relative; macro() after
     SMALL_STEPS (200) steps at relative L2 <= 1e-5; K3 at rtol 1e-6,
     atol 1e-7): the whole step and each kernel alone on lid 64^3,
     poiseuille 32^3, coronary (64, 48, 96) r=4 steady and pulsatile=[4,
     40] for 200 steps,
     curved_vessel 64^3, then lid 256^3 and the full-size coronary for 2
     steps; each kernel alone, the collide-stream kernel with its z-plane
     descriptors against step_plain (the x/y pass plus each z window's
     fixup); the launch over the fluid cells (fp32: the list kernel,
     sector-aligned segments with a word of wall links a lane) against
     the launch over every cell (out a copy of f: the kernels store fluid
     cells only).
     Then the
     collision branches (K1b), 200 steps each: lid 64^3 with TRT, MRT,
     Smagorinsky and the moving (bounce-back) lid, gravity_channel 32^3
     with BGK and TRT (MRT on the dense backend, the kernel route
     refusing it), pipe n=36 (staircase) with its force, poiseuille 32^3
     with power-law, Carreau (a=2, a=1.5) and Casson, and the pulsatile
     coronary with TRT + Carreau blood (its z planes run the closure
     in the same launch): BGK/TRT with and without force, MRT and the moving walls
     must be bit-equal, the closures within the tolerance above, K3 with
     the force shift bit-equal; the blood path's instance (TRT + Carreau
     blood at the full coronary's units) and the force path's
     (gravity_channel 256^3 TRT + force, bit-equal) at their own sizes
     for 2 steps. Then time kernels and plain versions in turns with CUDA
     events, with each kernel's bound (the bytes it must move over 3.35
     TB/s), including one collide-stream launch per branch at lid 256^3
     and gravity_channel 256^3 TRT+force, K1 over the fluid list against
     every cell at lid 256^3 and the full coronary, and the card's
     sustained copy rate (dst.copy_(src) of one lid 256^3 fp32 state, a
     yardstick on no path); at the full coronary K1 with its z planes,
     over every cell, and without its z planes (what they cost inside the
     launch, beside the plain fixups), and the list kernel's device time
     a launch by the profiler, with its launch tables' lanes and bytes;
  4. the lid main path: Simulation(lid_driven_cavity n=256).run(1000
     steps, time_save=250) and macro(), launch counters reset just
     before and read just after (K1a 1000 times over the full grid, K3
     at least once), finite, bounded fields;
  5. the vessel path: Simulation(coronary 291x291x372, radius=12,
     pulsatile=[40, 2000]).run(2000 steps, time_save=500) and macro(),
     counters reset just before and read just after (the list kernel
     [bgk] 2000, its three z planes in the same launch, no fixup launch,
     K3 at least 4), finite fields with max|u| within 3x the inlet speed,
     both buffers' non-fluid cells still the initial state; one step from
     the developed state against step_plain bit for bit (in phase 6 at
     rtol 3e-6 / atol 1e-7, in phase 15b the paired bf16 kernel), and K1d
     on 4 y shards of that state against their plain versions and,
     stitched, the whole box's step; a 200-step profile with
     one collide-stream launch and one velsum reduction a step (so in
     every vessel path);
  6. the blood path: the same coronary with collision='trt' and the
     Carreau blood closure (carreau_blood of its units), 2000 steps
     (one pulse period): counters reset just before and read just after
     (the TRT+Carreau collide-stream instance 2000, no fixup launch, K3
     at least 4), finite fields, max|u| within 3x the inlet
     speed, tau_eff inside the closure's clip and varying; ms/step, mlups,
     peak memory and a 200-step profile;
  7. the force path: gravity_channel n=256 nz=256 with collision='trt'
     and its default fz, 1000 steps (counters: TRT+force 1000, K3 with
     the force shift at least twice), finite fields, u_z > 0 at the duct
     centre, mean u_z rising, |u_x|, |u_y| <= 1e-3 max u_z;
  8. the CLI: `python -m lbm_tpu_torch run` on the 64^3 cavity for 500
     steps writes VTK and CONVERGENCE.log, on the default coronary
     (128, 64, 96) writes VTK with density, and on gravity_channel 64^3
     with --opt collision=trt writes VTK.
Scalar transport and thermal flow (K7, K8: lbm_scalar_stream; K1e: the
force-field instances of lbm_collide_stream):
  3b. (inside phase 3) each new instance against its plain version for
     200 steps, f and g bit for bit and the record series to 1e-12: K7 on
     poiseuille 32^3 wash-in with div_fix and on coronary (64, 48, 96)
     r=4 in mean-age mode and with a bolus gate; K8 on the pulsatile small
     coronary; K1e + K8 + Dirichlet walls on heated_cavity_3d n=32 and
     rayleigh_benard_3d 64x64x34 with BGK and TRT and on the periodic
     rayleigh_benard 32x1x18; then K7 and K8 per launch at the full
     coronary over the live list and K7, K8 and K1e at 256^3, in turns
     with their plain versions, with bounds; K7 and K8 launch over the
     scalar's cell list (the fluid cells and the footprints' cells), and
     the record's time a step (with it against without it) beside its
     bound and plane_means;
  9. the washout path: coronary 291x291x372 r=12 (steady), 2000 flow
     steps, then ScalarTransport with D=0.02 and a 500-step bolus at
     boundary 0 for 4000 steps, every boundary recorded (K7 4000
     launches; the profile at most two kernel launches a step, K7 and the
     record): finite, -0.01 <= c <= 1.1, the inlet record above 0.9
     inside the gate and below it after, total() > 0;
 10. the coupled washout path: the pulsatile full coronary through
     CoupledTransport, 2000 steps (K1a 2000, no fixup launch, K8 2000;
     at most four kernel launches a step), same checks;
 11. the thermal path: heated_cavity_3d n=256, Ra = 1e4, Pr = 0.71, 4 chunks
     of 250 steps with nusselt_profile each (K1e [bgk+field] 1000, K8
     1000, K3 at least 4): finite, temperature within the wall values +-
     1e-2, kinetic energy above zero and growing; then 250 steps with
     collision='trt' ([trt+field] 250, its four instances at three blocks
     an SM in phase 2);
 12. the CLI: `transport` on the default coronary with a bolus and --vtk
     writes the washout CSV and the concentration VTK; `thermal` at its
     defaults (cavity3d n=32, 4 x 5000 steps) ends with 1.8 < Nu < 2.3
     (Tric et al.: 2.0542).
Two fused steps per launch and the chunked state read (K2:
lbm_collide_stream2, K4: lbm_extract_rows):
  2b. (inside phase 2) ptxas registers, spills, shared memory and blocks
     an SM of the 14 K2 instances in each storage, and of K4;
  3c. (inside phase 3) K2 against two K1 launches (bit for bit) and its
     plain version (bit for bit; the closures at the tolerance above),
     100 launches (200 steps) each: lid 64^3 BGK, TRT, MRT, Smagorinsky
     and the moving lid, poiseuille 32^3 and with Carreau, curved_vessel
     64^3 (a series inlet whose phase moves inside pairs, over its
     live-unit list and against the full launch), gravity_channel 32^3
     TRT+force, pipe n=36, lid 66^3 TRT and gravity_channel 20x20x3
     (boxes the unit, an x segment of 64 planes of an 8 x 32 (y, z)
     column tile, does not fit); lid 256^3 for 2 launches; K4 against its
     plain
     version chunk by chunk on a stepped lid 256^3; then K2 a launch at
     lid 256^3 (BGK, TRT) and gravity_channel 256^3 TRT+force against
     two K1 launches, in turns, with its plain version and bound;
 13. the fuse2 path: Simulation(lid_driven_cavity n=256, fuse=2), 1000
     steps at time_save=250 (K2 500 launches, K1 none), velsum series,
     macro() and f against phase 4's fuse=1 run; then 999 steps at
     time_save=333 (K2 498, K1 3);
 14. the lowmem path: lid_driven_cavity 512^3 (lowmem by its size), 20
     steps, f_standard() through K4: each chunk bit for bit against
     f.narrow().cpu(), device memory up by at most one 256 MB chunk, host
     MemAvailable printed (a host that cannot hold the state fails the
     phase); K4 per chunk against its plain version and
     narrow().contiguous(); a lowmem save -> restore -> 2 steps round
     trip on the small pulsatile coronary, bit-equal to an uninterrupted
     run;
  8b. (inside phase 8) `run --fuse 2` on the 64^3 cavity and `run
     --lowmem --checkpoint-every 1` on the default coronary, each writing
     VTK and CONVERGENCE.log (and the checkpoint).
bf16 storage of the flow state (the bf16 instances of K1, its z planes
included, K2, K3 and K4, built from collide_stream_bf16.cu and
collide_stream2_bf16.cu; K1 on bf16 is the paired kernel, a thread a pair
of z-neighbour cells):
  2c. (inside phase 2) ptxas registers and spills of every bf16 instance
     (28 paired collide-stream, 14 K2, K3 with and without the force
     shift, K4), the build seconds of the five sources side by side, and
     the BGK instance's registers in both storage types (the paired
     kernel at most 80, three blocks an SM);
  3d. (inside phase 3) every bf16 instance against its plain version on
     bf16 state for 200 steps, f bit for bit (the closures, whose fp32
     transcendentals differ in the last bit, within 2e-2 of max |f|,
     lbm_tpu's bf16 tolerance; the values that differ are printed),
     velsums at 1e-5 relative, K1a (against step_plain) and K3 alone bit
     for bit, and the pair list's launch bit for bit the box's:
     lid 64^3 BGK, TRT, MRT, Smagorinsky and the moving lid, poiseuille
     32^3 Carreau, gravity_channel 32^3 TRT+force, pipe n=36, the
     pulsatile coronary (64, 48, 96) r=4 with its bf16 z planes, the same
     at nz 95 (an odd nz) and gravity_channel 23x23x25 TRT+force (an odd
     cell count); lid 256^3 and the full coronary for 2 steps; the
     paired kernel's division (div_exact) against IEEE a / b over all
     2^32 fp32 dividends for each launch divisor of those cases and
     0.99999994, 1.9999999, 0.49999997 and 1.0, 0 mismatches each; K2
     bf16 against its plain pair
     (one narrowing a pair) bit for bit on lid 64^3, curved_vessel 64^3
     over its live tiles and lid 256^3, against two bf16 K1 launches
     printed, not gated; then K1a [bgk+bf16], K3 [bf16] and K2
     [bgk+bf16] at lid 256^3, K1a (with and without its z planes) and K3
     on the full
     coronary, and K1a [trt+cy+bf16] over its live list, in turns with
     their plain versions, with bounds (76 B a fluid cell);
 15. the bf16 paths at full width, counters reset just before and read
     just after each: lid 256^3 bf16, 1000 steps at time_save=250 (K1a
     [bgk+bf16] 1000), ms/step beside phase 4's fp32 run, MLUPS against
     the bf16 ceiling (76 B a cell at 3.35 TB/s), macro() u against phase
     4's at relative L2, over the whole box, the driven rows below the
     lid and the resting bulk; lid 256^3 fuse=2 bf16, 1000 steps (K2
     [bgk+bf16] 500, K1 none); the full pulsatile coronary in bf16, 2000
     steps (K1a [bgk+bf16] 2000, no fixup launch, K3 [bf16] at least 4),
     finite fields, max|u| within 3x the inlet speed, then one K1 launch
     from the developed state bit for bit step_plain's; lid 512^3 bf16
     under lowmem, 20 steps, f_standard() through K4 [bf16] chunk by
     chunk against f.narrow().cpu(), device memory up by at most one
     chunk, its seconds beside phase 14's fp32 read;
  8c. (inside phase 8) `run --dtype bf16` on the 64^3 cavity and `run
     --dtype bf16 --lowmem --checkpoint-every 1` on the default coronary,
     each writing VTK and CONVERGENCE.log (the checkpoint float32).
The sharded collide-stream step (K1d: lbm_collide_stream_halo, its z
planes in the same launch, built from collide_stream_halo.cu once per
shard axis) and Simulation(mesh=) on torch.distributed:
  2d. (inside phase 2) the two halo units' build seconds and ptxas's
     registers and spills of their 56 instances; the 36 unsharded fp32
     instances' registers and spills, which must equal BASE_PTXAS (from
     probes/ptxas_report.py);
  3e. (inside phase 3) K1d (its z planes in the launch) on shards held in
     one process (no communication library: each shard's planes are its
     neighbours' edge rows), 20 steps of every fp32 branch on x or y on
     4 shards (lid 64^3, the small pulsatile coronary, gravity_channel
     32^3, poiseuille 32^3), then lid 256^3 on x and the full coronary on
     y (291 rows padded to 292) on 2 and 4 shards for 2 steps: each shard
     against its plain version and the stitched shards against the
     whole-box kernel step, bit for bit (the closures within rtol 3e-6 /
     atol 1e-7), velsums at 1e-5; K1d per launch on a 4-way shard by
     CUDA events in turns against its plain version and against K1a on
     the same local shape, and by the profiler's device time, with and
     without its z planes, with bounds (the local step's bytes plus the
     planes);
 16. the sharded paths on the one card: Simulation(mesh=) on 4 gloo ranks
     with CUDA tensors sharing the card (planes staged through pinned
     host memory), counters reset just before and read just after on
     each rank: lid 256^3 on x, 1000 steps at time_save=250, against
     phase 4's unsharded run; the full coronary on y, 200 steps at
     time_save=100 with the 'velsum' residual, against an unsharded run
     of the same steps: f_standard() bit for bit off the DEAD cells and
     zeros on them, the velsum series within 1e-5, the same stop step on
     every rank, K1d [bgk+halo] once a step on every rank and no z-plane
     fixup launch; ms/step and the
     exchange's ms a step of the one-card arrangement;
  8d. (inside phase 8) `run --shard 1` on the 64^3 cavity over NCCL (a
     process of its own, started with the build, its rank waiting for the
     build's lock; phase 8 checks what it wrote)
     writes VTK and CONVERGENCE.log;
 17. with two or more cards, the NCCL path on up to 4 of them, one rank
     a card: the full coronary on y, 200 steps, held as in phase 16
     against an unsharded run, then `run --shard N` on the 64^3 cavity
     writing VTK and CONVERGENCE.log; with one card a line saying the
     NCCL path for several cards was not run.
Windkessel (RCR) outlets and the clinical outputs (the fold: K1 with the
outlets' flux folded in, collide_stream_wk_kernel, and its reduction,
velsum_reduce_wk_kernel, built from windkessel.cu and windkessel_bf16.cu;
lbm_windkessel_flux, its prime, from windkessel.cu):
  2e. (inside phase 2) the windkessel units' build seconds and ptxas's
     registers, spills, stack frames and blocks an SM of the fold's 14
     instances in each storage type, its reduction and the flux kernel's
     four instances (with and without a force, fp32 and bf16);
 18. the clinical path: the fold of windkessel cases against its plain
     versions on the card (the prime alone against wk_terms_plain and,
     committed, windkessel_flux_plain; then each step the fold launch and
     its reduction against step_wk_plain, and the plain fold against
     lbm_tpu's order, a flux from each pre-step state then step_plain:
     f, P_c, the staged Q and the terms bit-equal, but for the closure
     case, f at rtol 3e-6, atol 1e-7, a bf16 state within 2e-2 of max |f|,
     P_c within 1e-6 of its largest value, the velsum within 1e-5): the
     pulsatile coronary (64, 48, 96) r=4 with four RCR outlets for 200
     steps, then from that developed state for 50 steps in fp32 and
     narrowed to bf16 (Q != 0 at every outlet, printed), for 50 steps in
     bf16 from rest, with TRT + Carreau blood, and poiseuille 32^3 with
     its y outlet; the full coronary 291x291x372 r=12 pulsatile [40,
     2000] with tools/demo_clinical_washout.py's RCR values for 2 steps;
     then its clinical run through Simulation.run, 2000 steps (counters
     reset just before and read just after: K1 [bgk+wk] 2000, the prime
     4, once a chunk, K3 at least 4), finite fields and P_c, max|u|
     within 3x the inlet speed, P_c in mmHg and the FFR between the inlet
     and the main outlet, 2000 more steps timed, a 200-step profile (at
     most 2.1 kernel launches a step: the fold and its reduction, the
     chunk's few); the prime and the fold step in turns with their plain
     versions, with bounds; one more period (2000 steps, untimed) with
     each outlet's Q and P_c logged every step and P_c held to the RCR
     recurrence of that Q in float64 at rtol 1e-4, each outlet's mean Q,
     mean Q Rd and end P_c printed; wss() and one WSSAccumulator sample
     at full size, their ms and device memory rise; then CoupledTransport
     on it (tau_g 0.6, a 500-step bolus, every boundary recorded), 2000
     steps (K1 [bgk+wk] and K8 2000 each, the prime once; at most four
     kernel launches a step), the washout checks of phase 9.
 19. curved walls and the live-cell (sparse) backend: the straight full
     coronary on 'sparse' against the kernel backend, 200 steps (counters
     reset just before and read just after: the list kernel [bgk] 200),
     f at the fluid cells of the two at rtol 3e-6 / atol 1e-7 and their
     velsum at 1e-5 relative; the kernel backend's wss() on the full
     coronary through
     the live-cell route (5 * 19 * 4 * cells > 6e9): ms, device memory
     rise, max difference against the dense pull (rtol 1e-5), and both
     routes' ms and rise, first call and later, on the default coronary
     (128x64x96 r=10, below the line); through the CLI (in this
     process) run --case pipe --backend dense and --backend sparse, run
     --case coronary --opt curved=true --backend sparse --snapshots
     --profile DIR (the three snapshot files and a trace with events).
     While the kernels build (phase 2), the parts that need no kernel
     (their ms/step share the host with nvcc): the full curved coronary
     (coronary curved=True, pulsatile=[40, 2000], 291x291x372 r=12) on
     backend='sparse' (2000 steps) and 'dense' (200), f at the fluid
     cells of the two at the same tolerance and their velsum at 1e-5
     relative after 200 steps, ms/step and peak device memory of each, a
     20-step profile of the sparse step (19a); in phase 3's process of
     its own (after its scalar and K1d checks, beside phase 3's other
     checks; its ms/step share the card with them), the pipe n=36 nz=4
     R=13.7 after 4000 dense steps, curved and
     staircase, its Hagen-Poiseuille error under 0.008 and under 0.35x
     the staircase's, and, in a process of its own, python -m
     lbm_tpu_torch run --case pipe on the kernel backend, which must
     exit non-zero with lbm_tpu's refusal. Its results are printed as
     one JSON object {"phase19": ...}.
Every mesh= path of lbm_tpu on torch.distributed (K7 on halo-row blocks,
the dense transports' and windkessel outlets' halo steps):
 20. the sharded transports and the windkessel route on the one card, 4
     gloo ranks sharing it in phase 16b's spawn (parallel/launch.
     run_many): (a) ScalarTransport(mesh=, backend='kernel') on the steady
     full coronary split along y (blocks of 73 rows and a halo row on each
     side), u from phase 9's flow, D=0.02, a 50-step bolus at boundary 0,
     every boundary recorded, 200 steps: K7 [frozen+comp] 200 times on
     every rank (counters reset just before and read just after), the
     gathered g bit for bit against an unsharded K7 run of the same steps,
     the records within rtol 2e-6 / atol 1e-8, finite, -0.01 <= c <= 1.1;
     ms/step and the halo rows' exchange alone; K7 a launch on rank 1's
     block against its plain version (bit-equal) and by CUDA events in
     turns with K7 on the same shape unsharded and the plain version, with
     bounds; (b) the clinical coronary on the dense backend (lbm_tpu's
     GSPMD windkessel route), 100 steps: every rank's P_c bit-equal and
     within 1e-6 of the largest of the unsharded dense run's, f within
     rtol 3e-6 / atol 1e-7 off the DEAD cells, ms/step and peak device
     memory per rank; (c) CoupledTransport with those outlets on the small
     clinical coronary (64, 48, 96) r=4, 100 steps, and BuoyantTransport
     on rayleigh_benard_3d 64x64x34 split along x, 200 steps with
     record_energy, each against its unsharded dense run (the buoyant f
     and g bit for bit, its energy within rtol 3e-6 / atol 1e-9); the
     unsharded dense runs of (b) and (c) need no kernel and run while the
     kernels build (phase 2). With two or more cards phase 17 runs (a)
     over NCCL too.
The differentiable and Lectures-family modules (engine/adjoint.py, ibm.py,
multiphase.py, binary.py: lbm_tpu steps them through its XLA dense step,
the port through its dense torch step, replayed as CUDA graphs on the
card), all but 21a's kernel run while the kernels build (phase 2), first
there, so their graph captures come before the build's library loads:
 21. (a) the adjoint at tools/demo_adjoint.py's default width (coronary
     96x96x120 r=7, four RCR outlets (1e-4, 5e3, 2e-3), a 600-step
     rollout, remat chunk 30): one value and gradient of the flow-split
     loss against the target 0.40/0.27/0.20/0.13 with its s/iteration
     and peak device memory (past 60 GiB the next smaller chunk of
     20/15/10), d loss / d log Rd_0 against central differences (h =
     0.1) at rtol 2e-2, three fit_windkessel iterations whose last loss is
     below the first; after the build the fitted terminations through
     Simulation on the kernel route (the windkessel fold) for 2000 steps,
     fields finite; (b) transport_rollout on a frozen poiseuille 64^3
     field, its diffusivity gradient against central differences at rtol
     2e-2; (c) lbm_tpu's slow physics anchors with their tests' shapes,
     steps and assertions: the 3D Laplace law (40^3, 3 x 3000 steps), the
     Gibbs-Thomson droplet (40^3, 8000 steps), Stokes' second problem,
     after the CUDA-graph step against the eager step, bit for bit; (d)
     ShanChen (G = -5), BinaryFluid and IBMFlow (two plates in a
     body-forced periodic channel, one and two forcing sweeps) at 256^3,
     200 steps each: finite, mass or Sigma phi within 1e-5 relative, the
     two-sweep no-slip defect below 0.6 of the one-sweep one, ms/step and
     peak device memory. Its results are printed as one JSON object
     {"phase21": ...}.
The geometry pipeline and the bifurcation case (geometry/native.py,
preprocess.py, reconstruct.py, cases/bifurcation.py, tools/
l0l7_bifurcation.py), on synthetic inputs made from a seed (a Y
bifurcation in the case's 64 x 83 x 32 box, a surface reconstructed from
4000 points sampled on it (rasterized at 3/4 of the box's resolution),
an inlet parabola of peak 0.05 in bc.txt's layout; the reference's
bif.stl, geo.txt and bc.txt are not in the repository), after phase 12:
 22. (a) the port's lbm_geo library built with g++ (its seconds), the
     synthetic inputs, smooth_mesh (inverse-distance, 8 iterations, and
     curvature, 1) on the surface's blocky mesh against the NumPy plain
     version at 1e-9, voxelize_mesh of the surface at spacing 1 against
     the NumPy parity cast (the cells that differ counted, at most 0.1%),
     and those voxels, their open ends extruded and labeled, leave a
     fluid path from the inlet to the outlet;
     (b) the bifurcation case on the kernel route, the list K1
     (lbm_collide_stream_list[bgk]: a field inlet with rho extrapolated
     at y = 1, rho* = 1 with u extrapolated at y = 81), against
     step_plain for 200 steps (phase 3's contract: f at rtol 3e-6 / atol
     1e-7, velsum at 1e-5 relative), then K1 alone and K3, counters reset
     just before and read just after; (c) the L0->L7 chain through
     tools/l0l7_bifurcation.l0l7: the surface voxelized back at spacing 1,
     its open ends extruded, then 4400 steps on it and on the synthetic
     geo.txt, counters reset just before and read just after (the list K1
     8800 times, K3 at least twice), both runs finite with max|u| within
     3x the inlet peak, their midplanes at z = 16 correlated at 0.9 or
     more; the residual, ms/step, MLUPS, compare_midplane's stats and
     the 3D common-fluid |du|max/|u|max printed; (d)
     `run --case bifurcation --opt geo_path=... bc_path=... --steps 400
     --snapshots` writes VTK, CONVERGENCE.log and the snapshots. Its
     results are printed as one JSON object {"phase22": ...}.
The 512^3 demos and the profile tools (lbm_tpu_torch/tools/
demo_512_outputs, demo_512_sharded, demo_512_washout, profile_clinical,
profile_shard), at their defaults, after phase 22; the 512^3 coronary
(radius 14) built once for 23a-23c by a process of its own started
after the build; its files, which the ranks of 23c map, and the phase's
own go to a .chip_smoke_ directory on the faster of the checkout and
the temporary directory (the write rates printed):
 23. (a) demo_512_outputs' stages: lowmem by its size, 20 + 20 steps of
     the list K1 (40 launches, no fixup), macro() through K3 (0 < |u|max
     <= 3x the inlet speed), the live-cell wss() (its first call timed),
     the binary VTK (walked field by field: DENSITY, PRESSURE, VELOCITY of
     the cropped box, K3 at least once), the uncompressed checkpoint (K4
     ceil(512 / chunk_rows) times inside its save), host MemAvailable and
     free disk checked first, a second Simulation restored from it beside
     the first and both stepped 5 steps: bit-equal; (c) demo_512_sharded:
     8 gloo ranks sharing the card, the spec handed over as files each
     rank maps, 2 steps of K1d over each rank's fluid cells (2 launches a
     rank), fewer listed lanes than window cells, the steps' velsums within
     1e-5 of (a)'s, each window finite with zeros at DEAD cells without a
     gather, its first and last y rows written; (b) demo_512_washout: its
     flow's first 2 steps, those rows bit-equal to the unsharded state,
     2000 flow steps, K7 over the scalar's cell list 3000 steps with
     every boundary recorded (a 500-step warm-up chunk, then chunks of
     500), phase 9's washout checks, at most two kernel launches a step
     in a 200-step profile; (d) profile_clinical's six rows at
     291x291x372 r=10 (300 steps warm, 300 timed), each row's launches a
     step from the counters (the collide-stream launch once a step, K8
     once a step where coupled, the fold's prime and the usq residual's K3
     at most once a chunk) and its collide-stream kernel's device ms from
     one profiler window; (e) profile_shard's four variants at lid 256^3
     (100 steps), each one more run counted: K1a for v1, K1d over the box
     for v2-v4, once a step. Its results are printed as one JSON object
     {"phase23": ...}.
The CLI's runs (phases 8, 12, 19 and 22) call lbm_tpu_torch.cli.main in this
process, as `python -m lbm_tpu_torch` does (cli_run), but for run
--shard, which spawns its ranks. Each phase's seconds are printed
("[t] phase ... took ... s").
Before the last line it prints one JSON object describing each kernel;
the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --nccl

runs phase 17 alone on every card of the machine (two or more), and

    python3 chip_smoke.py --phase21

phase 21 alone on one card, and

    python3 chip_smoke.py --phase22

phase 22 alone on one card, and

    python3 chip_smoke.py --phase23

phase 23 alone on one card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K1A_SOURCE = "lbm_tpu_torch/kernels/csrc/collide_stream.cu"
K1_LIST_SOURCE = "lbm_tpu_torch/kernels/csrc/collide_stream_list.cu"
K7_SOURCE = "lbm_tpu_torch/kernels/csrc/scalar_stream.cu"
K2_SOURCE = "lbm_tpu_torch/kernels/csrc/collide_stream2.cu"
K1A_BF16_SOURCE = "lbm_tpu_torch/kernels/csrc/collide_stream_bf16.cu"
K2_BF16_SOURCE = "lbm_tpu_torch/kernels/csrc/collide_stream2_bf16.cu"
K1D_SOURCE = "lbm_tpu_torch/kernels/csrc/collide_stream_halo.cu"
WK_SOURCE = "lbm_tpu_torch/kernels/csrc/windkessel.cu"
WK_BF16_SOURCE = "lbm_tpu_torch/kernels/csrc/windkessel_bf16.cu"
# the clinical run's RCR terminations (lattice Rp, C, Rd: the main outlet,
# then sub-outlets 5, 6 and 7), tools/demo_clinical_washout.py's
CLINICAL_WK = [(2e-4, 2e4, 1e-3)] + [(2e-4, 2e4, 3e-3)] * 3
HBM_BYTES_PER_S = 3.35e12   # published H100 SXM peak at 700 W
# lbm_tpu's bf16 tolerance (tests/test_pallas_kernel.py): a bf16 state
# within this share of max |f| of its reference
BF16_REL = 2e-2
FULL_CORONARY = dict(shape=[291, 291, 372], radius=12, pulsatile=[40, 2000])
# Steps of the small-size comparisons of phases 3, 3b and 3d (K2's: half
# as many launches)
SMALL_STEPS = 200
# launches of the lid 256^3 kernel timings (a timing's depth, no check's:
# 1000 before, when the script ran 1264.7 s on a slow host)
TIME_ITERS = 300
# steps of the curved coronary's sparse run (phase 19a)
CURVED_STEPS = 2000
STEADY_CORONARY = dict(shape=[291, 291, 372], radius=12)
# phase 20: the sharded K7 washout's steps, the dense windkessel runs' and
# the small buoyant run's; its small cases (parallel/launch.transport_setup)
PHASE20_STEPS = 200
PHASE20_WK_STEPS = 100
PHASE20_RB_STEPS = 200
SMALL_TRANSPORTS = {
    "coupled": ("case", "coronary", dict(shape=[64, 48, 96], radius=4,
                                         pulsatile=[4, 40],
                                         windkessel=CLINICAL_WK)),
    "buoyant": ("thermal", "rayleigh_benard_3d", dict(nx=64, ny=64, nz=34)),
}
# The 36 unsharded fp32 collide-stream instances as this build gives them
# (each branch without and with the z planes' code, "+z"; the fixup kernel
# gone): (registers, spill store bytes, spill load bytes), from
# probes/ptxas_report.py on kernels/csrc with kernels/_build.NVCC_FLAGS,
# on the H100's machine. Phase 2 requires the build to equal it, so a
# change to the kernel's registers or spills shows. The [trt+field*]
# instances took 90-92 registers, two blocks an SM, before their
# per-direction loop and launch bound.
BASE_PTXAS = {
    "collide_stream_kernel[bgk+closure+moving+z]": (77, 0, 0),
    "collide_stream_kernel[bgk+closure+moving]": (77, 0, 0),
    "collide_stream_kernel[bgk+closure+z]": (76, 0, 0),
    "collide_stream_kernel[bgk+closure]": (78, 0, 0),
    "collide_stream_kernel[bgk+field+moving+z]": (80, 0, 0),
    "collide_stream_kernel[bgk+field+moving]": (79, 0, 0),
    "collide_stream_kernel[bgk+field+z]": (80, 24, 40),
    "collide_stream_kernel[bgk+field]": (80, 24, 40),
    "collide_stream_kernel[bgk+force+moving+z]": (80, 0, 0),
    "collide_stream_kernel[bgk+force+moving]": (80, 0, 0),
    "collide_stream_kernel[bgk+force+z]": (80, 0, 0),
    "collide_stream_kernel[bgk+force]": (80, 0, 0),
    "collide_stream_kernel[bgk+moving+z]": (77, 0, 0),
    "collide_stream_kernel[bgk+moving]": (77, 0, 0),
    "collide_stream_kernel[bgk+z]": (76, 0, 0),
    "collide_stream_kernel[bgk]": (78, 0, 0),
    "collide_stream_kernel[mrt+moving+z]": (77, 0, 0),
    "collide_stream_kernel[mrt+moving]": (77, 0, 0),
    "collide_stream_kernel[mrt+z]": (76, 0, 0),
    "collide_stream_kernel[mrt]": (78, 0, 0),
    "collide_stream_kernel[trt+closure+moving+z]": (77, 0, 0),
    "collide_stream_kernel[trt+closure+moving]": (77, 0, 0),
    "collide_stream_kernel[trt+closure+z]": (76, 0, 0),
    "collide_stream_kernel[trt+closure]": (78, 0, 0),
    "collide_stream_kernel[trt+field+moving+z]": (80, 0, 0),
    "collide_stream_kernel[trt+field+moving]": (80, 0, 0),
    "collide_stream_kernel[trt+field+z]": (80, 8, 8),
    "collide_stream_kernel[trt+field]": (80, 0, 0),
    "collide_stream_kernel[trt+force+moving+z]": (80, 0, 0),
    "collide_stream_kernel[trt+force+moving]": (80, 0, 0),
    "collide_stream_kernel[trt+force+z]": (80, 0, 0),
    "collide_stream_kernel[trt+force]": (80, 0, 0),
    "collide_stream_kernel[trt+moving+z]": (75, 0, 0),
    "collide_stream_kernel[trt+moving]": (77, 0, 0),
    "collide_stream_kernel[trt+z]": (74, 0, 0),
    "collide_stream_kernel[trt]": (78, 0, 0),
}
# The fp32 launch over the fluid cells (collide_stream_list_kernel, one
# instance a branch, each with the z planes' code) as this build gives
# it: its 18 instances in collide_stream_list.cu (LIST_PTXAS) and the 28
# of the two shard units (HALO_LIST_PTXAS, tagged halo_x / halo_y),
# (registers, spill store bytes, spill load bytes), every one under a
# launch bound of six 128-thread blocks an SM; phase 2 requires the build
# to equal them.
LIST_PTXAS = {
    "collide_stream_list_kernel[bgk+closure+moving]": (72, 0, 0),
    "collide_stream_list_kernel[bgk+closure]": (72, 0, 0),
    "collide_stream_list_kernel[bgk+field+moving]": (80, 0, 0),
    "collide_stream_list_kernel[bgk+field]": (80, 0, 0),
    "collide_stream_list_kernel[bgk+force+moving]": (80, 0, 0),
    "collide_stream_list_kernel[bgk+force]": (80, 0, 0),
    "collide_stream_list_kernel[bgk+moving]": (72, 0, 0),
    "collide_stream_list_kernel[bgk]": (72, 0, 0),
    "collide_stream_list_kernel[mrt+moving]": (72, 0, 0),
    "collide_stream_list_kernel[mrt]": (72, 0, 0),
    "collide_stream_list_kernel[trt+closure+moving]": (72, 0, 0),
    "collide_stream_list_kernel[trt+closure]": (72, 0, 0),
    "collide_stream_list_kernel[trt+field+moving]": (72, 0, 0),
    "collide_stream_list_kernel[trt+field]": (72, 0, 0),
    "collide_stream_list_kernel[trt+force+moving]": (80, 0, 0),
    "collide_stream_list_kernel[trt+force]": (80, 0, 0),
    "collide_stream_list_kernel[trt+moving]": (72, 0, 0),
    "collide_stream_list_kernel[trt]": (72, 0, 0),
}
HALO_LIST_PTXAS = {
    "collide_stream_list_kernel[bgk+closure+halo_x]": (70, 0, 0),
    "collide_stream_list_kernel[bgk+closure+halo_y]": (72, 0, 0),
    "collide_stream_list_kernel[bgk+closure+moving+halo_x]": (70, 0, 0),
    "collide_stream_list_kernel[bgk+closure+moving+halo_y]": (72, 0, 0),
    "collide_stream_list_kernel[bgk+force+halo_x]": (80, 0, 0),
    "collide_stream_list_kernel[bgk+force+halo_y]": (80, 0, 0),
    "collide_stream_list_kernel[bgk+force+moving+halo_x]": (79, 0, 0),
    "collide_stream_list_kernel[bgk+force+moving+halo_y]": (80, 0, 0),
    "collide_stream_list_kernel[bgk+halo_x]": (70, 0, 0),
    "collide_stream_list_kernel[bgk+halo_y]": (70, 0, 0),
    "collide_stream_list_kernel[bgk+moving+halo_x]": (70, 0, 0),
    "collide_stream_list_kernel[bgk+moving+halo_y]": (71, 0, 0),
    "collide_stream_list_kernel[mrt+halo_x]": (70, 0, 0),
    "collide_stream_list_kernel[mrt+halo_y]": (70, 0, 0),
    "collide_stream_list_kernel[mrt+moving+halo_x]": (70, 0, 0),
    "collide_stream_list_kernel[mrt+moving+halo_y]": (71, 0, 0),
    "collide_stream_list_kernel[trt+closure+halo_x]": (70, 0, 0),
    "collide_stream_list_kernel[trt+closure+halo_y]": (72, 0, 0),
    "collide_stream_list_kernel[trt+closure+moving+halo_x]": (70, 0, 0),
    "collide_stream_list_kernel[trt+closure+moving+halo_y]": (72, 0, 0),
    "collide_stream_list_kernel[trt+force+halo_x]": (80, 0, 0),
    "collide_stream_list_kernel[trt+force+halo_y]": (80, 0, 0),
    "collide_stream_list_kernel[trt+force+moving+halo_x]": (80, 0, 0),
    "collide_stream_list_kernel[trt+force+moving+halo_y]": (80, 0, 0),
    "collide_stream_list_kernel[trt+halo_x]": (70, 0, 0),
    "collide_stream_list_kernel[trt+halo_y]": (70, 0, 0),
    "collide_stream_list_kernel[trt+moving+halo_x]": (70, 0, 0),
    "collide_stream_list_kernel[trt+moving+halo_y]": (71, 0, 0),
}
# The card's register file an SM and the threads of a collide-stream
# block: with a register count from ptxas, the blocks an SM can hold
# (registers are given out per warp in units of 256).
SM_REGISTERS = 65536
K1_THREADS = 256
# the collide-stream kernels as the profiler names them: the box launch,
# the fp32 launch over the fluid cells, the paired bf16 kernel
K1_KERNELS = ("collide_stream_kernel", "collide_stream_list_kernel",
              "collide_stream_pair_kernel")
T_START = time.perf_counter()


class SmokeFailure(RuntimeError):
    pass


# processes the script starts to run beside its phases: any still running
# when the script exits (a phase failed before collecting it) is killed
_CHILDREN: list = []


def _kill_children() -> None:
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def child(proc: subprocess.Popen) -> subprocess.Popen:
    """proc, killed at exit if it is still running then."""
    if not _CHILDREN:
        import atexit

        atexit.register(_kill_children)
    _CHILDREN.append(proc)
    return proc


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_LAST_MARK = [0.0]


def mark(phase: str) -> None:
    """Print the script's clock at a phase's end and the phase's seconds
    (since the previous mark)."""
    now = time.perf_counter() - T_START
    print(f"[t] phase {phase} done at {now:.1f} s, took "
          f"{now - _LAST_MARK[0]:.1f} s", flush=True)
    _LAST_MARK[0] = now


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls, by CUDA events, after
    iters // 5 warm-up calls."""
    import torch

    for _ in range(max(3, iters // 5)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(label, plain, kernel, iters_p, iters_k, names="plain/kernel"):
    """(kernel ms, plain ms): turns plain, kernel, kernel, plain."""
    p1, k1 = time_ms(plain, iters_p), time_ms(kernel, iters_k)
    k2, p2 = time_ms(kernel, iters_k), time_ms(plain, iters_p)
    a, b = names.split("/")
    print(f"[3] timing {label} (ms per call, turns {a}/{b}/{b}/{a}): "
          f"{p1:.4f} {k1:.4f} {k2:.4f} {p2:.4f}", flush=True)
    return (k1 + k2) / 2, (p1 + p2) / 2


def chunk_clock(marks: list):
    """An on_save callback for Simulation.run that appends the host clock
    at each chunk's end to `marks` (see chunk_ms)."""
    return lambda sim, t, residual: marks.append(time.perf_counter())


def chunk_ms(t0: float, marks: list, steps: int) -> str:
    """ms/step of each chunk of `steps` steps, from the run's start t0 and
    chunk_clock's marks."""
    return " ".join(f"{(b - a) / steps * 1e3:.4f}"
                    for a, b in zip([t0] + marks, marks))


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def step_bytes(cc, sel, bcs, pop: int = 4) -> int:
    """The least bytes that stepping the fluid cells `sel` ((X, Y, Z)
    bool) with the NEE boundaries `bcs` must move: each population they
    pull (a neighbor's, or their own opposite off a wall) and each own
    pre-step population an NEE rewrite reads, once; their 19 populations
    written once; their mask bytes; the valid bytes and phi* floats of
    their NEE directions. pop: bytes a population (4 fp32, 2 bf16).
    Non-fluid cells keep their state in both buffers, so they cost
    nothing."""
    import torch

    from lbm_tpu_torch.core.lattice import D3Q19
    from lbm_tpu_torch.geometry.mask import CellType

    wall = cc.mask == CellType.WALL
    nee = torch.zeros_like(sel)
    tables = 0
    for bc in bcs:
        on = bc.valid.any(0) & sel.select(bc.axis, bc.consumer_coord)
        nee.select(bc.axis, bc.consumer_coord).logical_or_(on)
        per_dir = 1 if bc.u_mode == "extrapolate" else 5
        tables += int(on.sum()) * len(bc.dirs) * per_dir
    reads = int((sel | nee).sum())             # population 0
    for j in range(1, 19):
        back = tuple(-int(v) for v in D3Q19.E[j])
        # population j of cell s is pulled by fluid cell s + e_j unless s
        # is a wall; off a wall at x + e_j, fluid cell x reads its own
        pulled = ((torch.roll(sel, back, (0, 1, 2)) & ~wall)
                  | (sel & torch.roll(wall, back, (0, 1, 2))))
        reads += int((pulled | nee).sum())
    return reads * pop + int(sel.sum()) * (19 * pop + 1) + tables


def rel_l2(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def lid_drift_split(u, ref, fluid) -> tuple[float, float]:
    """(driven, bulk): u's relative L2 against ref on a lid cavity of n
    cells a side over its driven rows, the fluid cells within n // 8 rows
    below the lid plane y = n - 2, and over the resting bulk beneath
    them. u, ref: (3, n, n, n); fluid: (n, n, n) bool."""
    n = fluid.shape[1]
    near = fluid.clone()
    near[:, : n - 2 - n // 8, :] = False
    return (rel_l2(u[:, near], ref[:, near]),
            rel_l2(u[:, fluid & ~near], ref[:, fluid & ~near]))


def check_close(name, got, ref, rtol, atol) -> float:
    """Raise unless |got - ref| <= atol + rtol |ref| everywhere; returns
    the max abs error."""
    import torch

    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    n_bad = int(bad.sum())
    require(n_bad == 0 and bool(torch.isfinite(got).all()),
            f"{name}: {n_bad} elements outside rtol={rtol} atol={atol} "
            f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def compare_case(case, steps, device, errs, macro_steps=None, spec=None,
                 exact=False, label=None):
    """Kernel vs plain on one case: the whole step (one collide-stream
    launch, its z planes included) for `steps` steps, then each kernel
    alone on the result (the collide-stream kernel against step_plain,
    the x/y pass plus each z window's fixup), the fluid-list launch
    against the full one, K3 (with the case's force shift), and
    optionally macro() after `macro_steps` steps of both backends. exact:
    every kernel must equal its plain version bit for bit. Returns the
    max abs errors {"f", "k1a", "z", "k3"}, "z" K1's on a case with z
    planes (0 without)."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    name, kw = case
    spec = spec or get_case(name, **kw)
    cc = compile_case(spec, device)
    f0 = initial_f(cc)
    fk, buf = f0.clone(), f0.clone()
    vs_k = torch.zeros(steps, dtype=torch.float64, device=device)
    fp = f0
    vs_p = torch.zeros(steps, dtype=torch.float64, device=device)
    for t in range(steps):
        K.step(fk, buf, cc, vs_k, t, t)
        fk, buf = buf, fk
        fp, vs_p[t] = K.step_plain(fp, cc, t)
    torch.cuda.synchronize()
    tag = label or f"{name} {tuple(spec.shape)} {kw}"
    e_f = check_close(f"step f after {steps} steps, {tag}", fk, fp, 3e-6,
                      1e-7)
    vs_rel = float(((vs_k - vs_p).abs() / vs_p.abs()).max())
    require(vs_rel <= 1e-5, f"step velsum {tag}: rel err {vs_rel:.3e}")
    # each kernel alone, from the same input
    t = steps
    s = torch.zeros(1, dtype=torch.float64, device=device)
    out_k = K.collide_stream(fk, buf, cc, s, 0, t)
    out_p, v_p = K.step_plain(fk, cc, t)
    e_k1 = check_close(f"K1a alone {tag}", out_k, out_p, 3e-6, 1e-7)
    require(abs(float(s[0] - v_p)) <= 1e-5 * abs(float(v_p)),
            f"K1a velsum {tag}")
    e_z = e_k1 if cc.z_bcs else 0.0
    if cc.live_blocks is not None:
        all_k = K.collide_stream(fk, torch.empty_like(fk).copy_(fk), cc, s,
                                 0, t, all_blocks=True)
        require(torch.equal(all_k, out_k),
                f"fluid-list launch differs from the full launch, {tag}")
    rho_k, u_k = K.macro(fk, cc.force)
    rho_p, u_p = K.macro_plain(fk, cc.force)
    e_m = max(check_close(f"K3 rho {tag}", rho_k, rho_p, 1e-6, 1e-7),
              check_close(f"K3 u {tag}", u_k, u_p, 1e-6, 1e-7))
    if exact:
        require(e_f == e_k1 == e_z == e_m == 0.0,
                f"{tag}: not bit-equal (f {e_f:.3e}, K1a {e_k1:.3e}, "
                f"z {e_z:.3e}, K3 {e_m:.3e})")
    errs["K1a"] = max(errs["K1a"], e_f, e_k1)
    errs["Kz"] = max(errs["Kz"], e_z)
    errs["K3"] = max(errs["K3"], e_m)
    live = ("every cell" if cc.fluid_cells is None
            else f"{cc.fluid_cells.numel()} listed fluid cells, equal to the "
            "full launch")
    print(f"[3] {tag}: step f max abs err {e_f:.3e} after {steps} steps, "
          f"velsum max rel err {vs_rel:.3e}; K1a alone {e_k1:.3e} ({live}"
          f"; {len(cc.z_bcs)} z planes in its launch); K3 {e_m:.3e}",
          flush=True)
    if macro_steps:
        sk = Simulation(spec, device=device, backend="kernel")
        sp = Simulation(spec, device=device, backend="dense")
        rk = sk.run(max_steps=macro_steps, time_save=macro_steps // 2,
                    verbose=False)
        rp = sp.run(max_steps=macro_steps, time_save=macro_steps // 2,
                    verbose=False)
        (rho_k, u_k), (rho_p, u_p) = sk.macro(), sp.macro()
        e_rho, e_u = rel_l2(rho_k, rho_p), rel_l2(u_k, u_p)
        require(e_rho <= 1e-5 and e_u <= 1e-5,
                f"macro() after {macro_steps} steps {tag}: rel L2 rho "
                f"{e_rho:.3e}, u {e_u:.3e} > 1e-5")
        if rk.velsum_series is not None:
            got, want = rk.velsum_series, rp.velsum_series
        else:  # the 'usq' flavor: its residuals (the first is inf)
            got, want = rk.residual_history[1:], rp.residual_history[1:]
        r_rel = max((abs(a - b) / abs(b) for a, b in zip(got, want)),
                    default=0.0)
        require(r_rel <= 1e-5,
                f"residual series over {macro_steps} steps {tag}: rel err "
                f"{r_rel:.3e} > 1e-5")
        print(f"[3] {tag}: macro() after {macro_steps} steps rel L2 rho "
              f"{e_rho:.3e} u {e_u:.3e}; residual series max rel err "
              f"{r_rel:.3e}", flush=True)
    return {"f": e_f, "k1a": e_k1, "z": e_z, "k3": e_m}


def branch_cases(blood):
    """The collision branches phase 3 holds against their plain versions:
    (label, case, options, bit-equal?). `blood`: the Carreau blood
    rheology dict of the small coronary's units."""
    carreau = {"model": "carreau", "nu0": 0.1, "nu_inf": 0.01,
               "lam": 100.0, "n": 0.4}
    small = dict(shape=[64, 48, 96], radius=4, pulsatile=[4, 40])
    return [
        ("lid 64^3 trt", "lid_driven_cavity", dict(n=64, collision="trt"),
         True),
        ("lid 64^3 mrt", "lid_driven_cavity", dict(n=64, collision="mrt"),
         True),
        ("lid 64^3 smag 0.15", "lid_driven_cavity",
         dict(n=64, smagorinsky_cs=0.15), False),
        ("lid 64^3 moving lid", "lid_driven_cavity",
         dict(n=64, lid="bounceback"), True),
        ("gravity_channel 32^3 bgk+force", "gravity_channel",
         dict(n=32, nz=32), True),
        ("gravity_channel 32^3 trt+force", "gravity_channel",
         dict(n=32, nz=32, collision="trt"), True),
        ("pipe n=36 staircase bgk+force", "pipe", dict(n=36, curved=False),
         True),
        ("poiseuille 32^3 power law", "poiseuille", dict(n=32, rheology={
            "model": "power_law", "K": 0.02, "n": 0.7}), False),
        ("poiseuille 32^3 carreau a=2", "poiseuille",
         dict(n=32, rheology=carreau), False),
        ("poiseuille 32^3 carreau a=1.5", "poiseuille",
         dict(n=32, rheology=dict(carreau, model="carreau_yasuda", a=1.5)),
         False),
        ("poiseuille 32^3 casson", "poiseuille", dict(n=32, rheology={
            "model": "casson", "nu_c": 0.02, "tau_y": 1e-5}), False),
        ("coronary (64,48,96) r=4 pulsatile trt+carreau blood", "coronary",
         dict(small, collision="trt", rheology=blood), False),
    ]


def pop_bytes(dtype) -> int:
    """Bytes a population in the storage dtype (None: float32)."""
    import torch

    return 2 if dtype == torch.bfloat16 else 4


def time_k1a(spec, device, iters_k, iters_p, label, dtype=None):
    """One collide-stream launch (the case's instance, on a state of
    `dtype`, float32 when None) against its plain version, by CUDA events
    in turns: {"ms", "plain_ms", "bound_ms", "instance"}."""
    import torch

    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    cc = compile_case(spec, device)
    dtype = dtype or torch.float32
    state = [initial_f(cc).to(dtype), initial_f(cc).to(dtype)]
    series = torch.zeros(1, dtype=torch.float64, device=device)
    plain_f = [state[0].clone()]

    def k1a():
        K.collide_stream(state[0], state[1], cc, series, 0, 0)
        state.reverse()

    def k1a_plain():
        plain_f[0] = K.step_plain(plain_f[0], cc, 0)[0]

    inst = K.instance(cc) + ("+bf16" if dtype == torch.bfloat16 else "")
    ms, plain_ms = in_turns(f"collide-stream [{inst}] {label}",
                            k1a_plain, k1a, iters_p, iters_k)
    out = {"ms": ms, "plain_ms": plain_ms, "instance": inst,
           "name": K.counter_name(cc, dtype),
           "bound_ms": bound_ms(step_bytes(cc, cc.fluid, cc.step_bcs,
                                           pop_bytes(dtype)))}
    if out["name"].startswith("lbm_collide_stream_list"):
        # a vessel's launch, whose events above the host's call a launch
        # may set: the kernel alone on one state (each call steps it
        # into the same dst) by the profiler
        fixed = [state[0].clone(), state[0].clone()]
        out["device_ms"] = k1_device_ms(lambda: K.collide_stream(
            fixed[0], fixed[1], cc, series, 0, 0))
        del fixed
        print(f"[3] {out['name']} {label}: device time "
              f"{out['device_ms']:.5f} ms a launch by the profiler on one "
              "state", flush=True)
    print(f"[3] bound of [{out['instance']}] {label}: "
          f"{out['bound_ms']:.4f} ms", flush=True)
    del state, plain_f
    free_device()
    return out


def time_lid(n, device, iters_k, iters_p, with_list=False, dtype=None):
    """{K1a, its plain version, K3, its plain version, K3's library call
    (on the widened state for bf16), K1a's and K3's bounds} in ms per
    call at lid n^3 on a state of `dtype` (float32 when None); with_list
    adds K1a over the fluid-cell list against K1a over every cell of the
    box ("list", "full")."""
    import dataclasses

    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.compile import (
        compile_case,
        fluid_cell_ids,
        live_block_ids,
    )
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    cc = compile_case(get_case("lid_driven_cavity", n=n), device)
    dtype = dtype or torch.float32
    state = [initial_f(cc).to(dtype), initial_f(cc).to(dtype)]
    series = torch.zeros(1, dtype=torch.float64, device=device)
    plain_f = [state[0].clone()]

    def k1a():
        K.collide_stream(state[0], state[1], cc, series, 0, 0)
        state.reverse()

    def k1a_plain():
        plain_f[0] = K.step_plain(plain_f[0], cc, 0)[0]

    f = state[0]
    out = {}
    out["k1a"], out["k1a_plain"] = in_turns(f"K1a lid {n}^3", k1a_plain,
                                            k1a, iters_p, iters_k)
    out["k3"], out["k3_plain"] = in_turns(
        f"K3 lid {n}^3", lambda: K.macro_plain(f), lambda: K.macro(f),
        iters_p, iters_k)
    out["k3_library"] = time_ms(moments_matmul(f.float()), iters_k)
    pop = pop_bytes(dtype)
    out["k1a_bound"] = bound_ms(step_bytes(cc, cc.fluid, cc.step_bcs, pop))
    out["k3_bound"] = bound_ms(n**3 * (19 * pop + 4 * 4))
    if with_list:
        ids = fluid_cell_ids(cc.spec.mask)
        listed = dataclasses.replace(
            cc, live_blocks=torch.from_numpy(live_block_ids(cc.spec.mask))
            .to(device), fluid_cells=torch.from_numpy(ids).to(device))

        def launch(case, all_blocks):
            def go():
                K.collide_stream(state[0], state[1], case, series, 0, 0,
                                 all_blocks)
                state.reverse()
            return go

        out["list"], out["full"] = in_turns(
            f"K1a lid {n}^3 over its {len(ids)} fluid cells of "
            f"{cc.mask.numel()}", launch(cc, True), launch(listed, False),
            iters_k, iters_k, names="every cell/fluid list")
    return out


def copy_rate(device) -> dict:
    """The card's sustained copy rate, a yardstick on no path:
    dst.copy_(src) of one lid 256^3 fp32 state (1.27 GB read and as much
    written) by CUDA events after a warm-up. {"ms", "gb_per_s"}, the
    rate counting the bytes read and written."""
    import torch

    src = torch.ones((19, 256, 256, 256), dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), 200)
    n_bytes = 2 * src.numel() * src.element_size()
    out = {"ms": ms, "gb_per_s": n_bytes / (ms * 1e-3) / 1e9}
    print(f"[3] the card's sustained copy rate: dst.copy_(src) of one lid "
          f"256^3 fp32 state, {ms:.4f} ms = {out['gb_per_s']:.1f} GB/s "
          f"(read plus written), {out['gb_per_s'] / 3350:.3f} of the "
          "published 3.35 TB/s; a yardstick, on no path", flush=True)
    del src, dst
    free_device()
    return out


def moments_matmul(f):
    """K3's yardstick: one torch.matmul of the (4, 19) moment matrix
    (rows 1 and e_x, e_y, e_z) with the (19, X*Y*Z) state, full fp32."""
    import torch

    from lbm_tpu_torch.core.lattice import D3Q19

    m = torch.zeros((4, 19), dtype=torch.float32, device=f.device)
    m[0] = 1.0
    m[1:] = torch.from_numpy(D3Q19.E.T.astype("float32")).to(f.device)
    flat = f.view(19, -1)
    return lambda: torch.matmul(m, flat)


def time_vessel(spec, device, dtype=None):
    """Times and bounds at the full-size coronary on a state of `dtype`
    (float32 when None): K1 over the fluid-cell list with its z-plane
    descriptors against step_plain, over every cell, and over the fluid
    list without the z planes (the same case with its x/y boundaries
    only), whose difference is what the z planes (K5 + K6) cost inside
    the launch; the plain z fixups of the three windows (the z planes'
    plain version); K3 and the one-matmul moments that K3's library_ms
    names (on the widened state for bf16)."""
    import dataclasses

    import torch

    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    cc = compile_case(spec, device)
    no_z = dataclasses.replace(cc, bcs=cc.kernel_bcs)
    n_cells = cc.mask.numel()
    dtype = dtype or torch.float32
    pop = pop_bytes(dtype)
    tag = " bf16" if dtype == torch.bfloat16 else ""
    f0 = initial_f(cc).to(dtype)
    state = [f0, f0.clone()]
    series = torch.zeros(1, dtype=torch.float64, device=device)
    out = {}

    def k1a(case, all_blocks):
        def go():
            K.collide_stream(state[0], state[1], case, series, 0, 0,
                             all_blocks)
            state.reverse()
        return go

    def k1a_plain():
        K.step_plain(state[0], cc, 0)

    out["k1a_live"], out["k1a_plain"] = in_turns(
        f"K1a{tag} coronary full, fluid list, x/y and z planes", k1a_plain,
        k1a(cc, False), 5, 1000)
    out["k1a_all"], _ = in_turns(
        f"K1a{tag} coronary full, every cell", k1a_plain, k1a(cc, True), 1,
        300)
    # with and without the z planes on one fixed state (each call steps
    # the same src into the same dst): the division's time moves with the
    # state a stepping comparison walks through
    fixed = [state[0].clone(), state[1].clone()]

    def once(case):
        return lambda: K.collide_stream(fixed[0], fixed[1], case, series, 0,
                                        0)

    out["k1a_no_z"], out["k1a_live_again"] = in_turns(
        f"K1a{tag} coronary full, fluid list, one state, with the z planes "
        "/ without", once(cc), once(no_z), 2000, 2000,
        names="with z/without z")
    # the kernel's device time (the events above include the host's call
    # a launch where it is the slower), with and without its z planes
    out["k1_device_ms"] = k1_device_ms(once(cc))
    out["k1_device_ms_no_z"] = k1_device_ms(once(no_z))
    out["z_device_ms"] = out["k1_device_ms"] - out["k1_device_ms_no_z"]
    out["name"] = K.counter_name(cc, dtype)
    if out["name"].startswith("lbm_collide_stream_list"):
        tables = cc.fluid_launch
        out["lanes"] = tables.links.numel()
        out["table_mb"] = tables.nbytes / 1e6
    print(f"[3] {out['name']}{tag} coronary full, one state: device time "
          f"{out['k1_device_ms']:.5f} ms a launch by the profiler, "
          f"{out['k1_device_ms_no_z']:.5f} without the z planes"
          + (f"; {out['lanes']} lanes for {int(cc.fluid.sum())} fluid "
             f"cells, launch tables {out['table_mb']:.2f} MB on the device"
             if "lanes" in out else ""), flush=True)
    del fixed
    n_live = cc.live_blocks.numel()
    # the same work whatever the launch covers: the fluid cells' step
    out["k1a_bound"] = bound_ms(step_bytes(cc, cc.fluid, cc.step_bcs, pop))
    out["live_share"] = n_live / -(-n_cells // 256)
    # the z planes inside the launch: its time and bytes beyond the x/y
    # pass; their plain version, the three windows' fixups
    out["z_ms"] = out["k1a_live_again"] - out["k1a_no_z"]
    out["z_bound"] = out["k1a_bound"] - bound_ms(
        step_bytes(cc, cc.fluid, cc.kernel_bcs, pop))
    f_out = state[1].clone()
    out["z_plain"] = time_ms(lambda: [K.fix_z_plane_plain(
        state[0], f_out, cc, bc, 0) for bc in cc.z_bcs], 5)

    f = state[0]
    out["k3"], out["k3_plain"] = in_turns(
        f"K3{tag} coronary full", lambda: K.macro_plain(f),
        lambda: K.macro(f), 5, 200)
    out["k3_library"] = time_ms(moments_matmul(f.float()), 200)
    out["k3_bound"] = bound_ms(n_cells * (19 * pop + 4 * 4))
    print(f"[3] coronary full{tag} bounds at 3.35 TB/s (ms): K1a "
          f"{out['k1a_bound']:.6f} ({int(cc.fluid.sum())} fluid cells, "
          f"{len(cc.step_bcs)} boundaries, {len(cc.z_bcs)} on z planes); "
          f"the z planes in the launch {out['z_ms']:.5f} ms beyond the x/y "
          f"pass (bound {out['z_bound']:.6f}, plain fixups "
          f"{out['z_plain']:.4f}); K3 {out['k3_bound']:.4f}; torch.matmul "
          f"moments {out['k3_library']:.4f} ms; live-block share "
          f"{out['live_share']:.4f}", flush=True)
    return out


def k1_device_ms(fn, n: int = 200) -> float:
    """The collide-stream kernel's device time a launch (K1_KERNELS; its
    velsum reduction left out) over n calls of fn, by the profiler: its
    time over the launches it saw."""
    by_name, _ = profile_steps(lambda: [fn() for _ in range(n)], n)
    seen = [v for k, v in by_name.items()
            if any(name in k for name in K1_KERNELS)]
    calls = sum(v[1] for v in seen)
    return sum(v[0] for v in seen) / calls if calls else 0.0


def profile_run(sim, steps):
    """profile_steps over a `steps`-step run of a Simulation (one
    chunk)."""
    return profile_steps(
        lambda: sim.run(max_steps=steps, time_save=steps, verbose=False),
        steps)


def short_name(kernel: str) -> str:
    """A profiler kernel name without its namespace noise and argument
    list, cut to 70 characters."""
    name = kernel.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(", 1)[0][:70]


def free_device():
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def cli_run(args: list) -> subprocess.CompletedProcess:
    """`python -m lbm_tpu_torch *args` in this process: lbm_tpu_torch.cli.
    main, which the package's __main__ calls, with its standard output
    captured. Its return code, or 1 and the traceback as stderr where it
    raises, as the interpreter would exit; the state it left is freed."""
    import traceback

    from lbm_tpu_torch.cli import main as cli_main

    buf, err = io.StringIO(), ""
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(list(args))
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    except Exception:
        rc, err = 1, traceback.format_exc()
    free_device()
    return subprocess.CompletedProcess(["lbm_tpu_torch", *args], rc,
                                       buf.getvalue(), err)


def blocks_per_sm(registers: int, threads: int = K1_THREADS) -> int:
    """Blocks of `threads` threads an SM holds at `registers` registers a
    thread, as the register file bounds them (at most 2048 threads)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = SM_REGISTERS // per_warp
    return min(warps // (threads // 32), 2048 // threads)


def ptxas_report(log: str, smem: dict | None = None, tag: str = "",
                 stack: dict | None = None) -> dict:
    """{"collide_stream_kernel[trt+force]": (registers, spill store bytes,
    spill load bytes), ...} from nvcc's -Xptxas -v output; instance names
    as kernels.collide_stream.instance names them ("closure" standing
    for every closure kind, one instance), with `tag` ("bf16" for the
    bf16 libraries) added inside the brackets. smem: filled with each
    kernel's static shared memory bytes; stack: with its stack frame
    bytes (a by-value parameter indexed at run time would show here)."""
    import re

    def name_of(mangled):
        name = plain_name(mangled)
        if not tag or name is None:
            return name
        if name.endswith("]"):
            return f"{name[:-1]}+{tag}]" if tag not in name else name
        return f"{name}[{tag}]"

    def plain_name(mangled):
        m = re.search(r"(collide_stream_kernel|collide_stream2_kernel|"
                      r"collide_stream_wk_kernel|collide_stream_pair_kernel|"
                      r"collide_stream_list_kernel)"
                      r"ILi(\d)ELb(\d)ELi(\d)ELb(\d)E"
                      r"(?:(?:f|13__nv_bfloat16)Li(?:n1|\d+)ELb([01])E"
                      r"|Lb([01])E)?", mangled)
        if m:
            kernel = m.group(1)
            if kernel == "collide_stream_wk_kernel":  # the windkessel fold
                kernel = "collide_stream_kernel"
            parts = [("bgk", "trt", "mrt")[int(m.group(2))]]
            if m.group(3) == "1":
                parts.append("closure")
            parts += [w for w in (("", "force", "field")[int(m.group(4))],)
                      if w]
            if m.group(5) == "1":
                parts.append("moving")
            if "1" in (m.group(6), m.group(7)):  # with the z planes' code
                parts.append("z")
            if m.group(1) == "collide_stream_wk_kernel":
                parts.append("wk")
            return f"{kernel}[{'+'.join(parts)}]"
        m = re.search(r"(scalar_stream_kernel)ILb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                      mangled)
        if m:
            parts = ["live" if m.group(2) == "1" else "frozen"]
            parts += [w for w, on in zip(("comp", "force", "dirichlet"),
                                         m.group(3, 4, 5)) if on == "1"]
            return f"{m.group(1)}[{'+'.join(parts)}]"
        if "scalar_record_kernel" in mangled:
            return "scalar_record_kernel"
        m = re.search(r"extract_rows_kernelI(6float4|f|13__nv_bfloat16)E",
                      mangled)
        if m:
            elem = {"6float4": "float4", "f": "f",
                    "13__nv_bfloat16": "bf16"}[m.group(1)]
            return f"extract_rows_kernel[{elem}]"
        m = re.search(r"(windkessel_flux_kernel)ILb(\d)E(f|13__nv_bfloat16)E",
                      mangled)
        if m:
            kind = "force" if m.group(2) == "1" else "plain"
            store = "+bf16" if m.group(3) != "f" else ""
            return f"{m.group(1)}[{kind}{store}]"
        m = re.search(r"(macro_kernel)ILb(\d)E", mangled)
        if m:
            return f"macro_kernel[{'force' if m.group(2) == '1' else 'plain'}]"
        m = re.search(r"(velsum_reduce_kernel|velsum_reduce_wk_kernel)",
                      mangled)
        return m.group(1) if m else None

    out, spills, cur = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = name_of(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            spills[cur] = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"(\d+) bytes stack frame", line)
            if m and stack is not None:
                stack[cur] = int(m.group(1))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = name_of(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if smem is not None:
                smem[cur] = int(m.group(1)) if m else 0
    return {k: (v,) + spills.get(k, (0, 0)) for k, v in out.items()}


def pair_blocks_per_sm(lib, tag: str = "") -> dict:
    """{"collide_stream2_kernel[trt+force]": blocks an SM, ...} of every K2
    instance of a pair library (lbm_pair_blocks_per_sm by instance key),
    named as ptxas_report names them, `tag` ("bf16") inside the
    brackets."""
    out = {}
    for key in range(36):
        n = lib.lbm_pair_blocks_per_sm(key)
        if n < 0:
            continue
        coll, closure, force, moving = (key // 12, key // 6 % 2,
                                        key // 2 % 3, key % 2)
        parts = [("bgk", "trt", "mrt")[coll]]
        parts += ["closure"] * closure + [("", "force", "field")[force]] * (
            force > 0) + ["moving"] * moving + [tag] * bool(tag)
        out[f"collide_stream2_kernel[{'+'.join(parts)}]"] = n
    return out


def vessel_path(spec, device, tag, inst, live_share, closure=False,
                store_dtype=None):
    """A 2000-step run of a full-size coronary through Simulation.run
    (store_dtype as Simulation takes it), counters reset just before and
    read just after: the collide-stream instance `inst` 2000 times (its
    three z planes in the same launch), no z-plane fixup launch, K3 at
    least 4; finite fields, max|u| within 3x the inlet speed, and with a
    closure tau_eff inside its clip. Prints the metrics and a 200-step
    profile, whose kernel launches a step must be the collide-stream
    kernel and its velsum reduction (and the residual's few a chunk);
    returns (launch counts, {"ms": ms/step, "launches_per_step",
    "device_ms", "busy"}: the step's device time and busy share)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.step import initial_f, tau_eff_field
    from lbm_tpu_torch.kernels import collide_stream as K

    t0 = time.perf_counter()
    sim = Simulation(spec, device=device, store_dtype=store_dtype)
    t_setup = time.perf_counter() - t0
    k3 = "lbm_macro[bf16]" if store_dtype == "bf16" else "lbm_macro"
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    res = sim.run(max_steps=2000, time_save=500, verbose=False)
    rho, u = sim.macro()
    torch.cuda.synchronize()
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    # fp32 over the fluid cells (collide_stream_list_kernel), bf16 by the
    # paired kernel
    name = K.counter_name(sim.cc, sim.f.dtype)
    require(name.endswith(f"[{inst}]") and counts.get(name) == 2000,
            f"{tag}: collide-stream {name} ([{inst}]) launches {counts} in "
            "a 2000-step run")
    require(not [k for k in counts if "fix_z_plane" in k],
            f"{tag}: a z-plane fixup was launched: {counts}")
    require(counts.get(k3, 0) >= 4,
            f"{tag}: the usq residual did not launch K3 ({k3})")
    require(res.steps == 2000, f"{tag}: run took {res.steps} steps")
    require(bool(torch.isfinite(rho).all() and torch.isfinite(u).all()),
            f"{tag}: non-finite fields")
    # the kernels store fluid cells only: both buffers keep the initial
    # non-fluid state
    keep = ~sim.cc.fluid
    f0 = initial_f(sim.cc).to(sim.f.dtype)
    same = all(torch.equal(sim.f[i][keep], f0[i][keep])
               and torch.equal(sim._spare[i][keep], f0[i][keep])
               for i in range(19))
    require(same, f"{tag}: the two buffers' non-fluid cells moved")
    del keep, f0
    # the path's kernel on the developed state (the paired kernel on bf16,
    # the launch over the fluid cells on fp32): one launch against
    # step_plain, bit for bit (a closure at rtol 3e-6 / atol 1e-7), velsum
    # at 1e-5; on fp32 without a closure K1d on 4 y shards of the same
    # state too
    s = torch.zeros(1, dtype=torch.float64, device=device)
    got = K.collide_stream(sim.f, sim.f.clone(), sim.cc, s, 0, sim.t)
    want, vs = K.step_plain(sim.f, sim.cc, sim.t)
    torch.cuda.synchronize()
    vs_rel = abs(float(s[0]) - float(vs)) / abs(float(vs))
    e_dev = check_close(f"{tag}: the step from the {sim.t}-step state "
                        "against step_plain", got.float(), want.float(),
                        3e-6, 1e-7)
    require((closure or e_dev == 0.0) and vs_rel <= 1e-5,
            f"{tag}: the step from the {sim.t}-step state differs from "
            f"step_plain (max abs {e_dev:.3e}, velsum rel {vs_rel:.3e})")
    print(f"{tag} one {name} step from the {sim.t}-step state against "
          f"step_plain: max abs err {e_dev:.3e}, velsum rel err "
          f"{vs_rel:.3e}", flush=True)
    if store_dtype is None and not closure:
        developed_halo(spec, sim, got, float(s[0]), device, tag)
    del got, want
    u_in = 0.1745 / 2.74909090909091
    fluid = sim.cc.fluid
    u_max = float(u.norm(dim=0)[fluid].max())
    rho_dev = float((rho[fluid] - 1.0).abs().max())
    require(u_max <= 3.0 * u_in,
            f"{tag}: max|u| {u_max:.4g} above 3x the inlet speed {u_in:.4g}")
    te_note = ""
    if closure:
        lo, hi = sim.cc.closure[-3], sim.cc.closure[-2]
        te = tau_eff_field(sim.cc, sim.f, sim.t)[fluid]
        te_lo, te_hi = float(te.min()), float(te.max())
        require(bool(torch.isfinite(te).all()) and te_lo >= float(
            np.float32(lo)) and te_hi <= float(np.float32(hi))
                and te_hi - te_lo > 1e-3,
                f"{tag}: tau_eff in [{te_lo}, {te_hi}], clip [{lo}, {hi}]")
        te_note = (f"; tau_eff over the fluid cells {te_lo:.4f}..{te_hi:.4f} "
                   f"(mean {float(te.mean()):.4f}, clip [{lo}, {hi}])")
        del te
    ms = res.elapsed_s / res.steps * 1e3
    print(f"{tag} coronary {tuple(spec.shape)} r=12 pulsatile [40, 2000]: "
          f"{res.steps} steps in {res.elapsed_s:.3f} s = {ms:.4f} ms/step "
          f"(host clock, synchronized), mlups {res.mlups:.1f}, mlups_live "
          f"{res.mlups_live:.1f}, mlups_box {res.mlups_box:.1f}; usq "
          f"residuals {[f'{r:.3e}' for r in res.residual_history]}; max|u| "
          f"{u_max:.4g} (inlet {u_in:.4g}), max|rho-1| {rho_dev:.3g}"
          f"{te_note}; both buffers' non-fluid cells equal the initial "
          f"state; live-block share {live_share:.4f}; set-up "
          f"{t_setup:.1f} s; peak device memory {peak:.2f} GiB; launches "
          f"{counts}", flush=True)
    del rho, u, fluid
    # the host clock of these paths spreads from run to run with the same
    # kernels: a second timed run of the same length
    res2 = sim.run(max_steps=2000, time_save=500, verbose=False)
    ms2 = res2.elapsed_s / res2.steps * 1e3
    print(f"{tag} a second run of 2000 steps: {ms2:.4f} ms/step (host "
          "clock, synchronized)", flush=True)
    by_name, busy = profile_run(sim, 200)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # tracing slows the host, so the busy share of the traced window
    # understates the untraced run's; give both
    dev_ms = sum(v[0] for v in by_name.values())
    print(f"{tag} profile of 200 more steps (device ms per step, calls per "
          "step): " + "; ".join(f"{short_name(k)} {v[0]:.5f} x{v[1]:.2f}"
                                for k, v in top)
          + f"; device {dev_ms:.5f} ms per step; device busy share "
          f"{busy:.3f} of the traced window, {dev_ms / ms:.3f} of the "
          "untraced step", flush=True)
    per_step = step_launches(by_name, tag)
    del sim
    free_device()
    return counts, {"ms": ms, "ms_again": ms2,
                    "launches_per_step": per_step, "device_ms": dev_ms,
                    "busy": dev_ms / ms, "developed_max_abs_err": e_dev}


def developed_halo(spec, sim, whole, whole_vs, device, tag):
    """K1d over the fluid cells of 4 y shards of a developed state (sim's,
    the vessel path's after its run): one step of each shard, its planes
    the neighbours' edge rows, against step_plain with the same halo and,
    stitched, against `whole` (the whole box's step of the same state,
    whose velsum is whole_vs): bit for bit, velsums at 1e-5."""
    import torch

    from lbm_tpu_torch.bridge import gather_windows, shard_window
    from lbm_tpu_torch.engine.compile import compile_shard
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.parallel.halo import ring_planes

    world = 4
    ccs = [compile_shard(spec, r, world, 1, device) for r in range(world)]
    fs = [shard_window(sim.f, r, world, 1) for r in range(world)]
    planes = ring_planes(fs, 1)
    vk = torch.zeros(world, dtype=torch.float64, device=device)
    got, err, vp_rel = [], 0.0, 0.0
    K.reset_launches()
    for r, c in enumerate(ccs):
        halo = c.halo(*planes[r])
        got.append(K.collide_stream(fs[r], fs[r].clone(), c, vk, r, sim.t,
                                    halo=halo))
        want, vp = K.step_plain(fs[r], c, sim.t, halo=halo)
        err = max(err, check_close(f"{tag} K1d rank {r} from the {sim.t}-"
                                   "step state against its plain version",
                                   got[r], want, 3e-6, 1e-7))
        vp_rel = max(vp_rel, abs(float(vk[r]) - float(vp))
                     / max(abs(float(vp)), 1e-300))
        del want
    torch.cuda.synchronize()
    counts = dict(K.launches)
    stitched = gather_windows(got, 1, spec.shape[1])
    e_whole = check_close(f"{tag} K1d stitched from the {sim.t}-step state "
                          "against the whole box", stitched, whole, 3e-6,
                          1e-7)
    vs_rel = abs(float(vk.sum()) - whole_vs) / abs(whole_vs)
    require(err == e_whole == 0.0 and vp_rel <= 1e-5 and vs_rel <= 1e-5
            and counts == {K.counter_name(ccs[0], halo=True): world},
            f"{tag} K1d from the {sim.t}-step state: max abs {err:.3e} "
            f"against plain, {e_whole:.3e} against the whole box, velsum "
            f"rel {vp_rel:.3e} / {vs_rel:.3e}, launches {counts}")
    print(f"{tag} K1d on {world} y shards from the {sim.t}-step state "
          f"({counts}): bit-equal to plain and, stitched, to the whole "
          f"box; velsum rel err {vp_rel:.3e} against plain, {vs_rel:.3e} "
          "against the whole box", flush=True)
    del got, stitched, fs, planes
    free_device()


def step_launches(by_name, tag) -> float | None:
    """Kernel launches a step in a profile_steps table: the path's
    collide-stream kernel and its velsum reduction equally often (a
    z-plane fixup kernel nowhere), plus what the residual and the chunk's
    read launch once a chunk. The profiler's window can miss a launch or
    two at its edges (it saw 196-197 of 200 on the H100), so the two
    counts may differ by that much and the count is taken per
    collide-stream launch, which the counters show is one a step. Prints
    and returns the launches a step."""
    kernels = {k: v for k, v in by_name.items() if "kernel" in k.lower()}
    if not kernels:
        print(f"{tag} the profiler saw no kernel: launches a step not "
              "measured", flush=True)
        return None
    k1 = sum(v[1] for k, v in kernels.items()
             if any(n in k for n in K1_KERNELS))
    red = sum(v[1] for k, v in kernels.items() if "velsum_reduce" in k)
    require(k1 >= 0.9 and abs(red - k1) <= 0.02
            and not [k for k in kernels if "fix_z_plane" in k],
            f"{tag}: profiled launches a step {kernels}")
    per_step = sum(v[1] for v in kernels.values()) / k1
    print(f"{tag} kernel launches a step {per_step:.3f} (the collide-stream "
          f"kernel and its velsum reduction once each, the rest once a "
          f"chunk; the profiler saw {k1:.3f} collide-stream launches a "
          "step)", flush=True)
    return per_step


def force_path(device):
    """gravity_channel n=256 nz=256, TRT, its default fz: two runs of 500
    steps through Simulation.run with macro() after each, counters reset
    just before and read just after (TRT+force 1000, K3 with the force
    shift at least twice). Returns the launch counts."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import collide_stream as K

    spec = get_case("gravity_channel", n=256, nz=256, collision="trt")
    sim = Simulation(spec, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    r1 = sim.run(max_steps=500, time_save=250, verbose=False)
    _, u1 = sim.macro()
    r2 = sim.run(max_steps=500, time_save=250, verbose=False)
    rho, u2 = sim.macro()
    torch.cuda.synchronize()
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    require(counts.get("lbm_collide_stream[trt+force]") == 1000,
            f"force path launches {counts} in 1000 steps")
    require(counts.get("lbm_macro[force]", 0) >= 2,
            "macro() did not launch K3 with the force shift")
    require(r1.steps == r2.steps == 500, "force path step count")
    require(bool(torch.isfinite(rho).all() and torch.isfinite(u2).all()),
            "force path: non-finite fields")
    fluid = sim.cc.fluid
    uz_centre = float(u2[2, 128, 128].min())
    mean1 = float(u1[2][fluid].mean())
    mean2 = float(u2[2][fluid].mean())
    uz_max = float(u2[2][fluid].max())
    uxy = float(u2[:2][:, fluid].abs().max())
    require(uz_centre > 0 and mean2 > mean1 > 0,
            f"force path: u_z at the centre {uz_centre:.4g}, mean u_z "
            f"{mean1:.4g} -> {mean2:.4g}")
    require(uxy <= 1e-3 * uz_max,
            f"force path: max |u_x|, |u_y| {uxy:.3g} above 1e-3 max u_z "
            f"{uz_max:.4g}")
    elapsed = r1.elapsed_s + r2.elapsed_s
    print(f"[7] force path gravity_channel 256^3 trt fz=1e-5: 1000 steps "
          f"in {elapsed:.3f} s = {elapsed / 1000 * 1e3:.6f} ms/step (host "
          f"clock, synchronized), mlups_box {r2.mlups_box:.1f}, mlups_live "
          f"{r2.mlups_live:.1f}; u_z at the centre {uz_centre:.4e}, mean "
          f"u_z {mean1:.4e} (500) -> {mean2:.4e} (1000), max u_z "
          f"{uz_max:.4e}, max |u_x|,|u_y| {uxy:.3e}; peak device memory "
          f"{peak:.2f} GiB; launches {counts}", flush=True)
    del sim, rho, u1, u2, fluid
    return counts


def scalar_bytes(sc, live: bool) -> int:
    """The least bytes one scalar step of the fluid cells must move,
    counted as step_bytes counts the flow's: per fluid cell its seven
    pulled g and seven written g, its mask byte, and the velocity's
    source: the frozen u (3 floats) and comp (1) or the flow state (19)."""
    n_fluid = int(sc.fluid.sum())
    vel = 19 * 4 if live else 3 * 4 + (4 if sc.comp is not None else 0)
    return n_fluid * (7 * 4 + 7 * 4 + 1 + vel)


def plain_steps(tr, n):
    """n steps of a transport's state with the kernel route's plain
    versions (never the kernels): the (n, n_bc) record series."""
    import torch

    from lbm_tpu_torch.kernels import scalar_stream as S

    series = torch.zeros((n, len(tr.sc.bcs)), dtype=torch.float64,
                         device=tr.sc.device)
    for k in range(n):
        if hasattr(tr, "cc"):
            tr.f, tr.g, series[k], _ = S.coupled_step_plain(
                tr.f, tr.g, tr.cc, tr.sc, tr.t + k, tr.field)
        else:
            tr.g, series[k] = S.scalar_stream_plain(tr.g, tr.sc, tr.t + k)
    tr.t += n
    return series


def compare_transport(label, make, steps, device, want_scalar, want_flow=None,
                      warm=0, need_z=False):
    """Kernel route against its plain versions on one transport: `make`
    builds it twice; one runs `steps` steps through run() (the kernels),
    the other through plain_steps. f and g must be bit-equal and the
    record series agree to 1e-12. warm: steps the first takes before
    the comparison (kernels), its state then copied into the second, so
    the compared steps start from a developed flow. The flow's
    collide-stream kernel must launch once a step, its z-plane boundaries
    in the same launch (no fixup launch); need_z: the case must have one.
    The scalar kernel launches over the case's cell list where it has one
    (sc.cells). Returns {"g", "f", "series"} max abs errors."""
    import torch

    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.kernels import scalar_stream as S

    a, b = make(), make()
    rec = list(range(len(a.sc.bcs)))
    if warm:
        a.run(warm)
        b.set_g(a.g)
        if hasattr(a, "cc"):
            b.set_f(a.f)
        b.t = a.t
    K.reset_launches()
    S.reset_launches()
    if hasattr(a, "buoyancy"):
        a.run(steps)
        sa = torch.zeros((steps, 0), dtype=torch.float64)
    else:
        sa = torch.from_numpy(a.run(steps, record=rec))
    sb = plain_steps(b, steps).cpu()
    torch.cuda.synchronize()
    counts = {**K.launches, **S.launches}
    require(counts.get(f"lbm_scalar_stream[{want_scalar}]") == steps,
            f"{label}: scalar launches {counts}")
    if want_flow is not None:
        n_z = sum(bc.window is not None for bc in a.cc.z_bcs)
        flow = K.counter_name(a.cc, field=a.field)
        require(flow.endswith(f"[{want_flow}]") and counts.get(flow) == steps
                and not [k for k in counts if "fix_z_plane" in k]
                and (n_z > 0 or not need_z),
                f"{label}: flow launches {counts} ({n_z} z planes)")
    out = {"g": check_close(f"g after {steps} steps, {label}", a.g, b.g,
                            3e-6, 1e-7), "f": 0.0}
    if hasattr(a, "cc"):
        out["f"] = check_close(f"f after {steps} steps, {label}", a.f, b.f,
                               3e-6, 1e-7)
    out["series"] = float((sa - sb).abs().max()) if sa.numel() else 0.0
    require(out["g"] == 0.0 and out["f"] == 0.0 and out["series"] <= 1e-12,
            f"{label}: not bit-equal (g {out['g']:.3e}, f {out['f']:.3e}, "
            f"record series {out['series']:.3e})")
    c = a.concentration()
    require(bool(torch.isfinite(c).all()) and float(c.abs().max()) > 0,
            f"{label}: the concentration did not move")
    print(f"[3] {label}: after {steps} steps"
          + (f" (from step {warm})" if warm else "")
          + f" max abs err g {out['g']:.3e}, "
          f"f {out['f']:.3e}, record series {out['series']:.3e} "
          f"({len(rec)} boundaries); scalar launch over "
          + ("every cell" if a.sc.cells is None else
             f"{a.sc.cells.numel()} listed cells ({int(a.sc.fluid.sum())} "
             "fluid)")
          + f"; launches {counts}; max|c| "
          f"{float(c.abs().max()):.4g}", flush=True)
    del a, b, c
    free_device()
    return out


def scalar_comparisons(full, device):
    """Phase 3 of the scalar and thermal kernels: every instance against
    its plain version, 200 steps each at small boxes, then 2 steps at the
    shapes of the washout, coupled washout and thermal paths. Returns
    ({instance: max abs err of f and g}, with the records' max abs error
    under "record series"; {path: its full-size max abs err}; the steady
    full coronary's velocity field, which the timings reuse)."""
    import dataclasses

    import numpy as np

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.cases import thermal as tcases
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.scalar import CoupledTransport, ScalarTransport
    from lbm_tpu_torch.engine.thermal import BuoyantTransport
    from lbm_tpu_torch.geometry.mask import CellType

    errs = {}

    def note(inst, e):
        errs[inst] = max(errs.get(inst, 0.0), e["g"], e["f"])
        errs["record series"] = max(errs.get("record series", 0.0),
                                    e["series"])

    def flow_u(spec, steps=200):
        sim = Simulation(spec, device=device)
        sim.run(max_steps=steps, time_save=steps, verbose=False)
        return sim.macro()[1]

    def gate(n):
        return {0: lambda t: 1.0 if t < n else 0.0}

    small = dict(shape=[64, 48, 96], radius=4)
    pois, cor = get_case("poiseuille", n=32), get_case("coronary", **small)
    u_p, u_c = flow_u(pois), flow_u(cor)
    frozen = (
        ("K7 poiseuille 32^3 wash-in, div_fix", "frozen+comp",
         lambda: ScalarTransport(pois, u_p, D=0.02, inlet_c={0: 1.0},
                                 device=device)),
        ("K7 coronary (64,48,96) r=4 mean age (source=1), div_fix",
         "frozen+comp",
         lambda: ScalarTransport(cor, u_c, D=0.02, inlet_c={0: 0.0},
                                 source=1.0, device=device)),
        ("K7 coronary (64,48,96) r=4 mean age, no div_fix", "frozen",
         lambda: ScalarTransport(cor, u_c, D=0.02, inlet_c={0: 0.0},
                                 source=1.0, div_fix=False, device=device)),
        ("K7 coronary (64,48,96) r=4 bolus gate 50", "frozen+comp",
         lambda: ScalarTransport(cor, u_c, D=0.02, device=device,
                                 inlet_c=gate(50))),
    )
    for label, inst, make in frozen:
        note(inst, compare_transport(label, make, SMALL_STEPS, device, inst))
    puls = get_case("coronary", **small, pulsatile=[4, 40])
    note("live", compare_transport(
        "K8 coronary (64,48,96) r=4 pulsatile [4,40], bolus gate 50",
        lambda: CoupledTransport(puls, D=0.02, device=device,
                                 inlet_c=gate(50)),
        SMALL_STEPS, device, "live", "bgk", need_z=True))
    thermal = (
        ("heated_cavity_3d n=32", tcases.heated_cavity_3d(n=32), True),
        ("rayleigh_benard_3d 64x64x34", tcases.rayleigh_benard_3d(), True),
        ("rayleigh_benard 32x1x18 (periodic)", tcases.rayleigh_benard(),
         False),
    )
    for label, (spec, kw, _), both in thermal:
        for coll in ("bgk", "trt") if both else ("bgk",):
            sp = dataclasses.replace(spec, collision=coll)
            e = compare_transport(
                f"K1e+K8 {label} {coll}",
                lambda sp=sp, kw=kw: BuoyantTransport(sp, device=device,
                                                      **kw),
                SMALL_STEPS, device, "live+force+dirichlet", f"{coll}+field")
            note("live+force+dirichlet", e)
            note(f"{coll}+field", e)

    # the force field with z-plane boundaries (the field instances of the
    # collide-stream kernel with z descriptors) and with moving walls: a buoyant scalar in the small
    # pulsatile tree, then the same tree with the walls of its x < 32 half
    # sliding along z
    rng = np.random.default_rng(0)
    c0_small = rng.random(tuple(puls.shape), dtype=np.float32)
    mask = np.array(puls.mask)
    mask[:32][mask[:32] == int(CellType.WALL)] = int(CellType.MOVING)
    sliding = dataclasses.replace(puls, mask=mask,
                                  wall_velocity=(0.0, 0.0, 1e-3))
    for what, base, sfx in (("buoyant", puls, ""),
                            ("buoyant, sliding walls", sliding, "+moving")):
        for coll in ("bgk", "trt"):
            sp = dataclasses.replace(base, collision=coll)
            e = compare_transport(
                f"K1e+K8 coronary (64,48,96) r=4 pulsatile [4,40] {what} "
                f"{coll}",
                lambda sp=sp: BuoyantTransport(
                    sp, D=0.02, buoyancy=(0.0, 1e-4, 2e-4), c_ref=0.5,
                    c0=c0_small, inlet_c=gate(50), device=device),
                SMALL_STEPS, device, "live+force", f"{coll}+field{sfx}",
                need_z=True)
            note("live+force", e)
            note(f"{coll}+field{sfx}", e)
    del c0_small

    # the three paths' own shapes, 2 steps each from a developed state on
    # a random scalar field, so every cell, live block and recorded plane
    # of the full boxes is compared
    at_full = {}
    steady = get_case("coronary", shape=FULL_CORONARY["shape"],
                      radius=FULL_CORONARY["radius"])
    u_full = flow_u(steady, 500)
    c0 = rng.random(tuple(full.shape), dtype=np.float32)
    e = compare_transport(
        "K7 coronary (291,291,372) r=12 on its 500-step flow, bolus gate",
        lambda: ScalarTransport(steady, u_full, D=0.02, c0=c0,
                                inlet_c=gate(500), device=device),
        2, device, "frozen+comp")
    note("frozen+comp", e)
    at_full["washout"] = max(e["g"], e["series"])
    e = compare_transport(
        "K8 coronary (291,291,372) r=12 pulsatile [40,2000], bolus gate",
        lambda: CoupledTransport(full, D=0.02, c0=c0, inlet_c=gate(500),
                                 device=device),
        2, device, "live", "bgk", warm=200, need_z=True)
    note("live", e)
    at_full["coupled washout"] = max(e["g"], e["f"], e["series"])
    del c0
    spec, kw, _ = tcases.heated_cavity_3d(n=256)
    kw = dict(kw, c0=rng.random((256,) * 3, dtype=np.float32) - 0.5)
    for coll in ("bgk", "trt"):
        sp = dataclasses.replace(spec, collision=coll)
        e = compare_transport(
            f"K1e+K8 heated_cavity_3d 256^3 {coll}",
            lambda sp=sp: BuoyantTransport(sp, device=device, **kw),
            2, device, "live+force+dirichlet", f"{coll}+field", warm=100)
        note("live+force+dirichlet", e)
        note(f"{coll}+field", e)
        at_full[f"thermal {coll}"] = max(e["g"], e["f"])
    return errs, at_full, u_full


def time_scalar(label, tr, device, iters_k, iters_p, record=False):
    """One scalar launch of a transport's instance against its plain
    version, in turns: {"ms", "plain_ms", "bound_ms", "instance"}; with a
    flow state (coupled, thermal) the live instance reads tr.f. record:
    also the launch with every boundary's record row (the record kernel
    after the step) in turns with the launch without, their difference
    the record's time ("record_ms"), its bound ("record_bound_ms": each
    footprint cell's plane value and lateral index read once, a double
    written a boundary) and its plain version's time (plane_means)."""
    import torch

    from lbm_tpu_torch.engine.scalar import plane_means
    from lbm_tpu_torch.kernels import scalar_stream as S

    live = hasattr(tr, "cc")
    f = tr.f if live else None
    state = [tr.g, tr._g_spare]
    n_bc = len(tr.sc.bcs)
    series = torch.zeros((1, n_bc), dtype=torch.float64, device=device)

    def kernel(rows=None):
        def go():
            S.scalar_stream(state[0], state[1], tr.sc, 0, f=f, series=rows)
            state.reverse()
        return go

    def plain():
        S.scalar_stream_plain(state[0], tr.sc, 0, f=f)

    inst = S.instance(tr.sc, live)
    ms, plain_ms = in_turns(f"lbm_scalar_stream [{inst}] {label}", plain,
                            kernel(), iters_p, iters_k)
    out = {"ms": ms, "plain_ms": plain_ms, "instance": inst,
           "bound_ms": bound_ms(scalar_bytes(tr.sc, live)),
           "fluid_cells": int(tr.sc.fluid.sum()),
           "listed_cells": (None if tr.sc.cells is None
                            else tr.sc.cells.numel())}
    print(f"[3] bound of lbm_scalar_stream [{inst}] {label}: "
          f"{out['bound_ms']:.6f} ms ({out['fluid_cells']} fluid cells, "
          f"launched over {out['listed_cells'] or 'every'} cells)",
          flush=True)
    if record:
        with_rec, without = in_turns(
            f"lbm_scalar_stream [{inst}] {label}, without / with the "
            f"record of its {n_bc} boundaries", kernel(), kernel(series),
            iters_k, iters_k, names="without/with")
        c = state[0].sum(0)
        out["record_ms"] = with_rec - without
        out["record_plain_ms"] = time_ms(lambda: plane_means(c, tr.sc.bcs),
                                         20)
        n_foot = int(tr.sc.foot.numel())
        out["record_bound_ms"] = bound_ms(n_foot * (4 + 4) + 8 * n_bc)
        out["footprint_cells"] = n_foot
        print(f"[3] the record of {label}: {out['record_ms']:.5f} ms a step "
              f"beyond the launch without it ({n_foot} footprint cells, "
              f"bound {out['record_bound_ms']:.7f} ms; plain plane_means "
              f"{out['record_plain_ms']:.4f} ms)", flush=True)
    return out


def time_field(bt, device, iters_k, iters_p, label):
    """One collide-stream launch of a BuoyantTransport's force-field
    instance against its plain version, in turns."""
    import torch

    from lbm_tpu_torch.kernels import collide_stream as K

    cc, field, g = bt.cc, bt.field, bt.g
    state = [bt.f, bt._f_spare]
    series = torch.zeros(1, dtype=torch.float64, device=device)

    def kernel():
        K.collide_stream(state[0], state[1], cc, series, 0, 0, field=field,
                         g=g)
        state.reverse()

    def plain():
        K.collide_stream_plain(state[0], cc, 0, field, g)

    inst = K.instance(cc, field)
    ms, plain_ms = in_turns(f"collide-stream [{inst}] {label}", plain,
                            kernel, iters_p, iters_k)
    n_bytes = step_bytes(cc, cc.fluid, cc.kernel_bcs) \
        + int(cc.fluid.sum()) * 7 * 4
    out = {"ms": ms, "plain_ms": plain_ms, "instance": inst,
           "bound_ms": bound_ms(n_bytes)}
    print(f"[3] bound of [{inst}] {label}: {out['bound_ms']:.4f} ms",
          flush=True)
    return out


def scalar_timings(full, u_full, device):
    """K7 and K8 a launch at the full coronary over the scalar's cell list
    (K7 on u_full, the tree's own flow field, with its record's time),
    and K7 (on the lid cavity's
    500-step flow), K8 and K1e (BGK and TRT) at 256^3, each in turns
    with its plain version."""
    import dataclasses

    import numpy as np

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.cases import thermal as tcases
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.scalar import CoupledTransport, ScalarTransport
    from lbm_tpu_torch.engine.thermal import BuoyantTransport

    out = {}
    tr = ScalarTransport(full, u_full, D=0.02, inlet_c={0: 1.0},
                         device=device)
    out["k7_coronary"] = time_scalar("coronary full, cell list", tr, device,
                                     1000, 3, record=True)
    del tr
    free_device()
    tr = CoupledTransport(full, D=0.02, inlet_c={0: 1.0}, device=device)
    out["k8_coronary"] = time_scalar("coronary full, cell list", tr, device,
                                     1000, 3)
    del tr
    free_device()
    lid = get_case("lid_driven_cavity", n=256)
    sim = Simulation(lid, device=device)
    sim.run(max_steps=500, time_save=500, verbose=False)
    u = sim.macro()[1]
    del sim
    tr = ScalarTransport(lid, u, D=0.02, inlet_c={0: 1.0}, device=device,
                         c0=np.ones(tuple(lid.shape), np.float32))
    del u
    out["k7_256"] = time_scalar("lid 256^3 on its 500-step flow", tr, device,
                                500, 5)
    del tr
    free_device()
    spec, kw, _ = tcases.heated_cavity_3d(n=256)
    bt = BuoyantTransport(spec, device=device, **kw)
    out["k8_256"] = time_scalar("heated_cavity_3d 256^3", bt, device, 500, 5)
    out["k1e_256"] = time_field(bt, device, 500, 5, "heated_cavity_3d 256^3")
    del bt
    free_device()
    bt = BuoyantTransport(dataclasses.replace(spec, collision="trt"),
                          device=device, **kw)
    out["k1e_trt_256"] = time_field(bt, device, 500, 5,
                                    "heated_cavity_3d 256^3")
    del bt
    free_device()
    return out


def profile_steps(run, steps):
    """Device time by kernel over run() (which advances `steps` steps), by
    torch.profiler: ({kernel name: (ms per step, launches per step)},
    device busy share of the traced wall time). Empty when the profiler
    sees no device activity. A window in which the tracer lost launches
    (no kernel seen 0.95 times a step or more, where each of these runs
    launches one at least once a step) is measured again, up to twice;
    every window's reading is printed and the fullest is returned. A
    window whose filler kernels (FILLER) came back short prints what the
    tracer dropped from them."""
    windows = []
    for _ in range(3):
        by_name, busy, fill = _profile_window(run, steps)
        seen = max((v[1] for v in by_name.values()), default=0.0)
        windows.append((by_name, busy, seen, fill))
        if seen >= 0.95:
            break
    for w in windows:
        if w[3] != (FILLER, FILLER):
            print(f"[profile] the tracer dropped filler kernels: "
                  f"{w[3][0]} of {FILLER} seen before the run, {w[3][1]} "
                  f"of {FILLER} after it; the run's busiest kernel "
                  f"{w[2]:.3f} launches a step", flush=True)
    if len(windows) > 1:
        print("[profile] the tracer lost launches: launches a step of the "
              "busiest kernel, device ms a step, in each of the "
              f"{len(windows)} windows: " + "; ".join(
                  f"{w[2]:.3f}, {sum(v[0] for v in w[0].values()):.5f}"
                  for w in windows) + " (the fullest kept)", flush=True)
    best = max(windows, key=lambda w: w[2])
    return best[0], best[1]


# spin kernels (torch.cuda._sleep) launched inside the recorded cycle on
# either side of the run, to take in the run's place the kernel records
# the tracer drops at a window's edge (probes/tracer_age.py: the first 16
# records after profile() opened, 0.2 s idle before them; in this
# script's long process, behind 20 warm-up launches, 0.92-0.95 of a
# path's launches were seen); they stay out of the table
FILLER = 256


def _profile_window(run, steps):
    """One profiler window over run(): profile_steps' table, and the
    filler kernels seen before and after the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    # a warm-up cycle, whose events are dropped, before the recorded one,
    # and 0.1 s asleep at either end of the recorded run: a window opened
    # cold missed launches (one run's trace held only 0.815 of a path's
    # launches a step, and 0.2 s asleep before the run still left 0.88-0.94
    # in a later one); the window closes 0.1 s after the last kernel ended,
    # in case the tracer drops kernels whose device timestamps fall past
    # the window's end (probes/tracer_window.py tests which end loses
    # them); FILLER spin kernels on either side of the run
    cycles = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: cycles.append(
                     (p.key_averages(), p.events()))) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(FILLER):
            warm.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.2)
        prof.step()
        time.sleep(0.1)
        for _ in range(FILLER):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(FILLER):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(0.1)
        prof.step()
    by_name, busy_ms = {}, 0.0
    table, events = cycles[0] if cycles else ((), ())
    for ev in table:
        if not str(ev.device_type).endswith("CUDA"):
            continue  # host-side events; their kernels are listed apart
        if ev.key.startswith("ProfilerStep") or "spin_kernel" in ev.key:
            continue  # the schedule's step annotation; the fillers
        dev_ms = getattr(ev, "device_time_total", 0.0) / 1e3
        if dev_ms > 0:
            by_name[ev.key] = (dev_ms / steps, ev.count / steps)
            busy_ms += dev_ms
    # the fillers before and after the run, split at its first kernel
    starts = [(("spin_kernel" in ev.name), ev.time_range.start)
              for ev in events if str(ev.device_type).endswith("CUDA")
              and not ev.name.startswith("ProfilerStep")]
    first = min((t for spin, t in starts if not spin), default=float("inf"))
    before = sum(1 for spin, t in starts if spin and t < first)
    after = sum(1 for spin, t in starts if spin and t > first)
    return by_name, busy_ms / wall_ms, (before, after)


def print_profile(tag, by_name, busy, ms):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    dev_ms = sum(v[0] for v in by_name.values())
    print(f"{tag} profile of 200 more steps (device ms per step, calls per "
          "step): " + "; ".join(f"{short_name(k)} {v[0]:.5f} x{v[1]:.2f}"
                                for k, v in top)
          + f"; device {dev_ms:.5f} ms per step; device busy share "
          f"{busy:.3f} of the traced window, {dev_ms / ms:.3f} of the "
          "untraced step", flush=True)


def check_washout(tag, tr, series, gate):
    """The washout checks: finite series and field, -0.01 <= c <= 1.1 at
    fluid cells, the inlet record above 0.9 inside the gate and below it
    after, total() > 0. Prints every boundary's peak."""
    import numpy as np
    import torch

    c = tr.concentration()
    cf = c[tr.fluid]
    require(bool(np.isfinite(series).all()) and bool(torch.isfinite(c).all()),
            f"{tag}: non-finite series or field")
    c_lo, c_hi = float(cf.min()), float(cf.max())
    require(-0.01 <= c_lo and c_hi <= 1.1,
            f"{tag}: c in [{c_lo:.4g}, {c_hi:.4g}] outside [-0.01, 1.1]")
    inlet = series[:, 0]
    require(inlet[:gate].max() > 0.9 and inlet[-1] < 0.9,
            f"{tag}: inlet record max {inlet[:gate].max():.4f} inside the "
            f"gate, {inlet[-1]:.4f} at the end")
    total = tr.total()
    require(total > 0, f"{tag}: total() = {total}")
    peaks = "; ".join(
        f"bc{k} peak {series[:, k].max():.5f} at step "
        f"{int(series[:, k].argmax())}, final {series[-1, k]:.5f}"
        for k in range(series.shape[1]))
    print(f"{tag} c over the fluid cells {c_lo:.4g}..{c_hi:.4g}, total() "
          f"{total:.6g}; {peaks}", flush=True)


def washout_path(device, u_path=None):
    """coronary 291x291x372 r=12 (steady): 2000 flow steps, then the
    frozen-field transport, D=0.02, a 500-step bolus at boundary 0, 4000
    steps, every boundary recorded (K7 over the cell list and the record
    kernel: at most two launches a transport step). u_path: where the
    flow's macro() u is saved as .npy (phase 20's frozen field). Returns
    (the launch counts, {"ms", "launches_per_step", "device_ms", "busy",
    "record_ms"}, the record kernel's device ms a launch by the profiler,
    None where it saw none)."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.scalar import ScalarTransport
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.kernels import scalar_stream as S

    tag = "[9] washout path"
    spec = get_case("coronary", shape=[291, 291, 372], radius=12)
    rec = list(range(len(spec.boundaries)))
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    S.reset_launches()
    sim = Simulation(spec, device=device)
    flow = sim.run(max_steps=2000, time_save=1000, verbose=False)
    u = sim.macro()[1]
    del sim
    if u_path is not None:
        import numpy as np

        np.save(u_path, u.cpu().numpy())
    t0 = time.perf_counter()
    tr = ScalarTransport(spec, u, D=0.02, device=device,
                         inlet_c={0: lambda t: 1.0 if t < 500 else 0.0})
    del u
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    series = tr.run(4000, record=rec)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {**K.launches, **S.launches}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    require(counts.get("lbm_scalar_stream[frozen+comp]") == 4000
            and counts.get("lbm_collide_stream_list[bgk]") == 2000,
            f"{tag}: launches {counts}")
    require(series.shape == (4000, len(rec)), f"{tag}: series {series.shape}")
    ms = elapsed / 4000 * 1e3
    print(f"{tag} coronary (291, 291, 372) r=12 steady: 2000 flow steps at "
          f"{flow.elapsed_s / flow.steps * 1e3:.4f} ms/step, transport set-up "
          f"{t_setup:.2f} s, 4000 transport steps in {elapsed:.3f} s = "
          f"{ms:.4f} ms/step (host clock, synchronized), "
          f"{int(tr.fluid.sum()) / ms / 1e3:.1f} M fluid-cell updates/s; g "
          f"2 x {tr.g.numel() * 4 / 1e9:.2f} GB; peak device memory "
          f"{peak:.2f} GiB; launches {counts}", flush=True)
    check_washout(tag, tr, series, 500)
    ms2 = timed_again(tag, lambda: tr.run(2000, record=rec), 2000)
    by_name, busy = profile_steps(lambda: tr.run(200, record=rec), 200)
    print_profile(tag, by_name, busy, ms)
    del tr
    free_device()
    return counts, dict(path_profile(tag, by_name, ms, 2), ms_again=ms2)


def timed_again(tag, run, steps) -> float:
    """ms a step of a second timed run of a path (its host clock spreads
    from run to run with the same kernels)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    print(f"{tag} a second run of {steps} steps: {ms:.4f} ms/step (host "
          "clock, synchronized)", flush=True)
    return ms


def path_profile(tag, by_name, ms, at_most):
    """{"ms", "launches_per_step", "device_ms", "busy", "record_ms"} of a
    transport path from its profile_steps table: the kernel launches a
    step, required to be at most `at_most` (the once-a-chunk launches of
    the series read aside), the device ms a step and its share of the
    untraced step, and the record kernel's device ms a launch."""
    kernels = {k: v for k, v in by_name.items() if "kernel" in k.lower()}
    # a step launches the scalar kernel once; the profiler's window can
    # miss a launch at its edges, so count per scalar launch
    unit = sum(v[1] for k, v in kernels.items()
               if "scalar_stream_kernel" in k)
    per_step = sum(v[1] for v in kernels.values()) / unit if unit else None
    require(per_step is None or per_step <= at_most + 0.05,
            f"{tag}: {per_step} kernel launches a step, more than "
            f"{at_most}: {kernels}")
    dev_ms = sum(v[0] for v in by_name.values())
    rec = [v[0] / v[1] for k, v in kernels.items()
           if "scalar_record_kernel" in k]
    print(f"{tag} kernel launches a transport step {per_step}; record "
          f"kernel {rec[0] if rec else None} ms of device time a launch",
          flush=True)
    return {"ms": ms, "launches_per_step": per_step, "device_ms": dev_ms,
            "busy": dev_ms / ms, "record_ms": rec[0] if rec else None}


def coupled_path(full, device):
    """The pulsatile full coronary through CoupledTransport on the kernel
    route, 2000 steps with a 500-step bolus, every boundary recorded (K1
    with its z planes, its velsum reduction, K8 over the cell list and
    the record: at most four launches a step). Returns (the launch
    counts, path_profile's numbers)."""
    import torch

    from lbm_tpu_torch.engine.scalar import CoupledTransport
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.kernels import scalar_stream as S

    tag = "[10] coupled washout path"
    rec = list(range(len(full.boundaries)))
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    S.reset_launches()
    tr = CoupledTransport(full, D=0.02, device=device,
                          inlet_c={0: lambda t: 1.0 if t < 500 else 0.0})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    series = tr.run(2000, record=rec)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {**K.launches, **S.launches}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    require(counts.get("lbm_scalar_stream[live]") == 2000
            and counts.get("lbm_collide_stream_list[bgk]") == 2000
            and not [k for k in counts if "fix_z_plane" in k],
            f"{tag}: launches {counts}")
    rho, u = tr.macro()
    require(bool(torch.isfinite(rho).all() and torch.isfinite(u).all()),
            f"{tag}: non-finite flow")
    ms = elapsed / 2000 * 1e3
    print(f"{tag} coronary (291, 291, 372) r=12 pulsatile [40, 2000]: 2000 "
          f"steps in {elapsed:.3f} s = {ms:.4f} ms/step (host clock, "
          f"synchronized); peak device memory {peak:.2f} GiB; launches "
          f"{counts}", flush=True)
    del rho, u
    check_washout(tag, tr, series, 500)
    ms2 = timed_again(tag, lambda: tr.run(1000, record=rec), 1000)
    by_name, busy = profile_steps(lambda: tr.run(200, record=rec), 200)
    print_profile(tag, by_name, busy, ms)
    del tr
    free_device()
    return counts, dict(path_profile(tag, by_name, ms, 4), ms_again=ms2)


def compare_wk(label, spec, steps, device, dtype=None, start=None,
               exact=True):
    """A windkessel case's kernel route against its plain versions on the
    card for `steps` steps, one state of `dtype` (float32 when None) from
    rest or from `start` = (f, P_c) (f narrowed to dtype): first the flux
    kernel's prime alone against wk_terms_plain (terms and Q) and, through
    the commit, windkessel_flux_plain (P_c' and rho*); then each step the
    fold launch (K1 with its windkessel x/y and z planes deriving rho*,
    the footprint's terms, the reduction committing P_c and staging Q)
    against step_wk_plain, and the plain fold against lbm_tpu's order (a
    flux from each pre-step state, then step_plain). exact: f, P_c, the
    staged Q and the terms bit-equal, and the plain fold bit-equal to
    lbm_tpu's order; else f within rtol 3e-6, atol 1e-7 (a bf16 state
    within lbm_tpu's bf16 share of max |f|), P_c within 1e-6 of its
    largest value. The velsum within 1e-5 relative either way. Returns the
    errors, the starting Q and whether everything was bit-equal."""
    import torch

    from lbm_tpu_torch.engine.compile import compile_case, wk_init
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    cc = compile_case(spec, device)
    dtype = dtype or torch.float32
    if start is None:
        f = initial_f(cc).to(dtype)
        wk0 = torch.from_numpy(wk_init(cc.bcs)).to(device)
    else:
        f, wk0 = start[0].to(dtype), start[1].clone()
    fk, buf = f.clone(), f.clone()
    wk_k, wk_p = wk0.clone(), wk0.clone()
    # the prime alone
    terms_p, q_p = K.wk_terms_plain(f, cc)
    stage = K.windkessel_prime(fk, cc)
    w_flux, rho_flux = K.windkessel_flux_plain(f, cc, wk0)
    w_fold, rho_fold = K.wk_commit_plain(cc, wk0, stage.q)
    torch.cuda.synchronize()
    prime_bit = bool(torch.equal(stage.q, q_p)
                     and torch.equal(stage.terms, terms_p)
                     and torch.equal(w_fold, w_flux)
                     and torch.equal(rho_fold, rho_flux))
    rho_err = float((rho_fold - rho_flux).abs().max())
    q0 = stage.q.tolist()
    vs_k = torch.zeros(steps, dtype=torch.float64, device=device)
    vs_p = torch.zeros_like(vs_k)
    g, wk_g = f.clone(), wk0.clone()
    order_bit = True
    for t in range(steps):
        K.collide_stream(fk, buf, cc, vs_k, t, t, wk=wk_k)
        fk, buf = buf, fk
        f, vs_p[t], wk_p, terms_p, q_p = K.step_wk_plain(f, cc, t, wk_p, q_p)
        if exact:  # lbm_tpu's order: a flux from each pre-step state
            wk_g, rho = K.windkessel_flux_plain(g, cc, wk_g)
            g, _ = K.step_plain(g, cc, t, rho_wk=rho)
            order_bit = order_bit and bool(torch.equal(g, f)
                                           and torch.equal(wk_g, wk_p))
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        err = float((fk.float() - f.float()).abs().max())
        require(err <= BF16_REL * float(f.float().abs().max()),
                f"{label}: bf16 f max abs err {err:.3e}")
    else:
        err = check_close(f"{label} f", fk, f, 3e-6, 1e-7)
    pc_err = float((wk_k - wk_p).abs().max()) / max(
        float(wk_p.abs().max()), 1e-30)
    vs_err = float(((vs_k - vs_p).abs() / vs_p.abs()).max())
    require(pc_err <= 1e-6 and vs_err <= 1e-5
            and bool(torch.isfinite(wk_k).all()),
            f"{label}: P_c rel err {pc_err:.3e}, velsum {vs_err:.3e}, "
            f"P_c {wk_k.tolist()}")
    bit = bool(prime_bit and torch.equal(fk, f) and torch.equal(wk_k, wk_p)
               and torch.equal(stage.q, q_p)
               and torch.equal(stage.terms, terms_p))
    require(bit and order_bit or not exact,
            f"{label}: not bit-equal (the prime {prime_bit}, the fold "
            f"against step_wk_plain {bit}, the plain fold against lbm_tpu's "
            f"order {order_bit})")
    print(f"[18] {label}: {steps} steps from "
          f"{'rest' if start is None else 'a developed state'}, the fold "
          f"against its plain versions: f max abs err {err:.3e}, P_c rel err "
          f"{pc_err:.3e}, rho* (the prime, committed) max abs err "
          f"{rho_err:.3e}, velsum rel err {vs_err:.3e}, bit-equal {bit} (the "
          f"prime {prime_bit}; the plain fold against lbm_tpu's order "
          f"{order_bit if exact else 'not run'}); Q at the start {q0}; P_c "
          f"{wk_k.tolist()}", flush=True)
    return {"f": err, "pc": pc_err, "rho": rho_err, "vs": vs_err,
            "bit_equal": bit, "prime_bit_equal": prime_bit, "q0": q0,
            "state": (fk, wk_k)}


def wk_flux_bytes(cc, pop: int = 4) -> int:
    """The least bytes the flux kernel (the prime) moves: each footprint
    cell's 19 populations, its id and weight read once, its term written;
    each outlet's Q written."""
    from lbm_tpu_torch.kernels import collide_stream as K

    lists = K.wk_lists(cc)
    n = int(lists.cells.numel())
    return n * (19 * pop + 4 + 4 + 4) + len(lists.rows) * 4


def pc_recurrence(sim, steps, tag):
    """One period of the clinical run through the fold, untimed: `steps`
    direct calls of the step on sim's state and P_c, each outlet's staged
    Q and P_c read after every step. The host recomputes P_c from the
    logged Q by the backward-Euler recurrence in float64, P(n + 1) = (P(n)
    + Q(n) / C) / (1 + 1 / (Rd C)) from the card's P(0), and the card's P_c
    must meet it at rtol 1e-4 (with an atol of 1e-4 of the outlet's
    largest |P|, for a P that crosses zero). Every 50 steps the plane flux
    of every boundary (engine/diagnostics.plane_flux on macro()'s u), so
    the outlets' Q stands beside the inlet's. Returns each outlet's mean
    Q, mean Q Rd, end P_c (lattice units and mmHg), the boundaries' mean
    plane flux and the largest error."""
    import numpy as np
    import torch

    from lbm_tpu_torch.engine.diagnostics import MMHG_PER_PA, plane_flux
    from lbm_tpu_torch.kernels import collide_stream as K

    cc, device = sim.cc, sim.device
    stage = K.windkessel_prime(sim.f, cc)
    n_wk = sim.wk.numel()
    q_log = torch.empty(steps + 1, n_wk, device=device)
    pc_log = torch.empty(steps + 1, n_wk, device=device)
    q_log[0], pc_log[0] = stage.q, sim.wk
    series = torch.empty(steps, dtype=torch.float64, device=device)
    n_bcs = len(sim.spec.boundaries)
    fluxes = []
    for n in range(steps):
        if n % 50 == 0:
            u = sim.macro()[1]
            fluxes.append([plane_flux(sim.spec, u, b) for b in range(n_bcs)])
            del u
        K.step(sim.f, sim._spare, cc, series, n, sim.t, wk=sim.wk)
        sim.f, sim._spare = sim._spare, sim.f
        sim.t += 1
        q_log[n + 1], pc_log[n + 1] = stage.q, sim.wk
    q, pc = q_log.cpu().double().numpy(), pc_log.cpu().double().numpy()
    rcr = [bc.windkessel for bc in cc.bcs if bc.windkessel is not None]
    cap = np.array([c for _, c, _ in rcr])
    rd = np.array([r for _, _, r in rcr])
    host = np.empty_like(pc)
    host[0] = pc[0]
    for n in range(steps):
        host[n + 1] = (host[n] + q[n] / cap) / (1.0 + 1.0 / (rd * cap))
    err = np.abs(pc - host)
    scale = np.abs(host).max(axis=0)
    require(bool((err <= 1e-4 * np.abs(host) + 1e-4 * scale).all()),
            f"{tag}: P_c off the RCR recurrence of its logged Q: max abs err "
            f"{err.max(axis=0).tolist()} against max |P| {scale.tolist()}")
    big = np.abs(host) > 1e-2 * scale
    rel = float((err[big] / np.abs(host[big])).max())
    to_mmhg = sim.spec.units.C_pre * MMHG_PER_PA
    mean_flux = np.mean(fluxes, axis=0).tolist()
    out = {"steps": steps, "mean_q": q[:-1].mean(axis=0).tolist(),
           "mean_plane_flux_by_boundary": mean_flux,
           "mean_q_rd": (q[:-1].mean(axis=0) * rd).tolist(),
           "mean_q_rd_mmhg": (q[:-1].mean(axis=0) * rd * to_mmhg).tolist(),
           "min_q": q[:-1].min(axis=0).tolist(),
           "max_q": q[:-1].max(axis=0).tolist(),
           "end_pc": pc[-1].tolist(), "end_pc_mmhg": (pc[-1] * to_mmhg).tolist(),
           "mean_pc_mmhg": (pc[1:].mean(axis=0) * to_mmhg).tolist(),
           "max_abs_err": err.max(axis=0).tolist(),
           "max_rel_err_above_1pct": rel}
    print(f"{tag} P_c against the RCR recurrence of the logged Q, {steps} "
          f"steps (float64 on the host): max abs err "
          f"{out['max_abs_err']}, max rel err {rel:.3e} where |P| > 1% of "
          f"its largest; per outlet mean Q {out['mean_q']} (min "
          f"{out['min_q']}, max {out['max_q']}), mean Q Rd "
          f"{out['mean_q_rd']} = {out['mean_q_rd_mmhg']} mmHg; each "
          f"boundary's mean outward plane flux (every 50 steps, the inlet "
          f"first) {mean_flux}; mean P_c "
          f"{out['mean_pc_mmhg']} mmHg, end P_c {out['end_pc']} = "
          f"{out['end_pc_mmhg']} mmHg", flush=True)
    return out


def clinical_path(device):
    """The clinical coronary (phase 18): the windkessel kernels (the fold
    and its prime) against their plain versions on small cases (the
    pulsatile coronary with four RCR outlets for 200 steps, then from its
    developed state in fp32 and narrowed to bf16, Q != 0 at every outlet,
    and from rest in bf16, with TRT + Carreau blood, and poiseuille's x/y
    outlet alone, 50 steps each) and on the full coronary with the
    clinical RCR values for 2 steps; then the full coronary's clinical
    run through Simulation.run, 2000 steps and 2000 more, timed (counters
    reset just before and read just after the first: K1 [bgk+wk] 2000,
    the prime once a chunk), P_c in mmHg and the FFR between the inlet and
    the main outlet; the prime and the fold step timed against their plain
    versions; one more period untimed with P_c held against the RCR
    recurrence of the logged Q; WSS and one WSSAccumulator sample at full
    size; then the coupled washout with the windkessel outlets and a gated
    bolus. Returns the numbers of the kernels line."""
    import numpy as np
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.core.rheology import carreau_blood
    from lbm_tpu_torch.engine.diagnostics import MMHG_PER_PA, ffr
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import collide_stream as K

    tag = "[18] clinical path"
    out = {"errs": {}}
    small = dict(shape=[64, 48, 96], radius=4, windkessel=CLINICAL_WK)
    small_spec = get_case("coronary", **small, pulsatile=[4, 40])
    label = "coronary (64, 48, 96) r=4 pulsatile [4, 40], 4 RCR outlets"
    out["errs"][label] = compare_wk(label, small_spec, 200, device)
    developed = out["errs"][label].pop("state")
    for sfx, dtype in (("", None), (", narrowed to bf16", torch.bfloat16)):
        label = ("coronary (64, 48, 96) r=4 pulsatile, 4 RCR outlets, from "
                 f"the 200-step state{sfx}")
        e = compare_wk(label, small_spec, 50, device, dtype,
                       start=developed)
        require(all(q != 0.0 for q in e["q0"]),
                f"{label}: Q {e['q0']} is 0 at an outlet")
        out["errs"][label] = e
    del developed
    for label, spec, dtype, steps, exact in (
            ("coronary (64, 48, 96) r=4 pulsatile, 4 RCR outlets, bf16",
             small_spec, torch.bfloat16, 50, True),
            ("coronary (64, 48, 96) r=4, 4 RCR outlets, trt+carreau blood",
             get_case("coronary", **small, collision="trt",
                      rheology=carreau_blood(small_spec.units)), None, 50,
             False),
            ("poiseuille 32^3, an RCR outlet on its y plane",
             get_case("poiseuille", n=32, windkessel=(5e-4, 24000.0, 2.5e-3)),
             None, 50, True)):
        out["errs"][label] = compare_wk(label, spec, steps, device, dtype,
                                        exact=exact)
    full = get_case("coronary", **FULL_CORONARY, windkessel=CLINICAL_WK)
    out["errs"]["coronary full clinical"] = compare_wk(
        "coronary full (291, 291, 372) r=12 pulsatile [40, 2000], the "
        "clinical RCR outlets", full, 2, device)
    for e in out["errs"].values():
        e.pop("state", None)
    free_device()

    t0 = time.perf_counter()
    sim = Simulation(full, device=device)
    t_setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    res = sim.run(max_steps=2000, time_save=500, verbose=False)
    rho, u = sim.macro()
    torch.cuda.synchronize()
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    # the fold every step, its prime once a chunk
    require(counts.get("lbm_windkessel_flux") == 4
            and counts.get("lbm_collide_stream[bgk+wk]") == 2000
            and counts.get("lbm_macro", 0) >= 4 and res.steps == 2000,
            f"{tag}: launches {counts} in a {res.steps}-step run")
    require(sim.wk.device == device and bool(torch.isfinite(sim.wk).all())
            and bool(torch.isfinite(rho).all() and torch.isfinite(u).all()),
            f"{tag}: non-finite fields or P_c {sim.wk}")
    u_in = 0.1745 / 2.74909090909091
    fluid = sim.cc.fluid
    u_max = float(u.norm(dim=0)[fluid].max())
    require(u_max <= 3.0 * u_in,
            f"{tag}: max|u| {u_max:.4g} above 3x the inlet speed")
    ms = res.elapsed_s / res.steps * 1e3
    pc_mmhg = (sim.wk.cpu().numpy() * full.units.C_pre
               * MMHG_PER_PA).tolist()
    f_ffr, dp = ffr(full, rho, 0, 1)
    require(np.isfinite(f_ffr) and np.isfinite(dp), f"{tag}: ffr {f_ffr}")
    print(f"{tag} coronary (291, 291, 372) r=12 pulsatile [40, 2000], RCR "
          f"{CLINICAL_WK}: {res.steps} steps in {res.elapsed_s:.3f} s = "
          f"{ms:.4f} ms/step (host clock, synchronized), mlups "
          f"{res.mlups:.1f}; max|u| {u_max:.4g}; P_c (mmHg gauge) "
          f"{[float(f'{v:.6g}') for v in pc_mmhg]}; FFR inlet -> main outlet "
          f"{f_ffr:.6f} (trans-tree drop {dp:.6f} mmHg); set-up "
          f"{t_setup:.1f} s; peak device memory {peak:.2f} GiB; launches "
          f"{counts}", flush=True)
    del rho, u, fluid
    ms2 = timed_again(tag, lambda: sim.run(max_steps=2000, time_save=500,
                                           verbose=False), 2000)
    by_name, busy = profile_run(sim, 200)
    print_profile(tag, by_name, busy, ms)
    kern = {k: v for k, v in by_name.items() if "kernel" in k.lower()}

    def calls(name):
        return sum(v[1] for k, v in kern.items() if name in k)

    k1 = calls("collide_stream_wk_kernel")
    per_step = sum(v[1] for v in kern.values()) / k1 if k1 else None
    dev = {name: [v[0] / v[1] for k, v in kern.items() if name in k]
           for name in ("windkessel_flux_kernel", "collide_stream_wk_kernel",
                        "velsum_reduce_wk_kernel")}
    # the fold and its reduction once a step (the profiler's window may
    # miss a launch at its edges); the prime and the usq residual's few
    # once a chunk (0.061 a step over 200 steps on the prescribed-outlet
    # path)
    require(per_step is None or (
        k1 >= 0.9 and calls("windkessel_flux_kernel") <= 0.011
        and abs(calls("velsum_reduce_wk_kernel") - k1) <= 0.02
        and per_step <= 2.1),
            f"{tag}: {per_step} kernel launches a step: {kern}")
    print(f"{tag} kernel launches a step {per_step} (the fold's K1 and its "
          f"reduction; the prime and the chunk's few once a chunk); device "
          f"ms a launch: {dev}", flush=True)
    dev_ms = sum(v[0] for v in by_name.values())
    out["path"] = {"ms": ms, "ms_again": ms2, "launches_per_step": per_step,
                   "device_ms": dev_ms, "busy": dev_ms / ms,
                   "pc_mmhg": pc_mmhg, "ffr": f_ffr, "dp_mmhg": dp,
                   "peak_gib": peak}
    out["counts"] = counts
    out["flux_device_ms"] = dev["windkessel_flux_kernel"][0] if \
        dev["windkessel_flux_kernel"] else None
    out["k1_device_ms"] = dev["collide_stream_wk_kernel"][0] if \
        dev["collide_stream_wk_kernel"] else None
    out["reduce_device_ms"] = dev["velsum_reduce_wk_kernel"][0] if \
        dev["velsum_reduce_wk_kernel"] else None

    # the prime and the fold step against their plain versions (the fold
    # on two copies of the state in turn, so no call primes)
    cc = sim.cc
    state = [sim.f.clone(), sim._spare.clone()]
    wk_t = sim.wk.clone()
    series = torch.zeros(1, dtype=torch.float64, device=device)
    out["flux_ms"], out["flux_plain_ms"] = in_turns(
        "lbm_windkessel_flux (the prime) coronary full clinical",
        lambda: K.wk_terms_plain(state[0], cc),
        lambda: K.windkessel_prime(state[0], cc), 20, 2000)
    out["flux_bound_ms"] = bound_ms(wk_flux_bytes(cc))
    q_t = K.wk_stage(cc).q.clone()

    def fold_step():
        K.collide_stream(state[0], state[1], cc, series, 0, 0, wk=wk_t)
        state.reverse()

    out["step_ms"], out["step_plain_ms"] = in_turns(
        "K1 [bgk+wk] + its reduction (the fold), coronary full clinical",
        lambda: K.step_wk_plain(state[0], cc, 0, wk_t.clone(), q_t),
        fold_step, 3, 1000)
    out["k1_bound_ms"] = bound_ms(step_bytes(cc, cc.fluid, cc.step_bcs)
                                  + 12 * K.wk_lists(cc).foot.numel())
    print(f"{tag} bounds at 3.35 TB/s (ms): the prime "
          f"{out['flux_bound_ms']:.7f} ({int(K.wk_lists(cc).cells.numel())} "
          f"footprint cells); K1 with the windkessel planes and the "
          f"footprint's terms {out['k1_bound_ms']:.6f}", flush=True)
    del state
    out["pc_recurrence"] = pc_recurrence(sim, 2000, tag)

    # the wall outputs at full size
    free_device()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    w = sim.wss()
    torch.cuda.synchronize()
    wss_ms = (time.perf_counter() - t0) * 1e3
    wss_rise = (torch.cuda.max_memory_allocated(device) - before) / 2**30
    require(bool(torch.isfinite(w).all()) and float(w.max()) > 0,
            f"{tag}: WSS not finite or zero")
    w_pa = float(w.max()) * full.units.C_pre
    t0 = time.perf_counter()
    w = sim.wss()
    torch.cuda.synchronize()
    wss_ms2 = (time.perf_counter() - t0) * 1e3
    del w
    free_device()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    acc = sim.wss_accumulator()
    acc.sample_sim(sim)
    torch.cuda.synchronize()
    acc_ms = (time.perf_counter() - t0) * 1e3
    acc_rise = (torch.cuda.max_memory_allocated(device) - before) / 2**30
    tawss = acc.tawss_field()
    require(bool(torch.isfinite(tawss).all()) and acc.n_samples == 1,
            f"{tag}: TAWSS not finite")
    print(f"{tag} WSS at full size: sim.wss() {wss_ms:.1f} ms (first call, "
          f"the wall normals built), {wss_ms2:.1f} ms again, device memory "
          f"rise {wss_rise:.2f} GiB, max WSS {w_pa:.4g} Pa; a WSSAccumulator "
          f"and one sample {acc_ms:.1f} ms, rise {acc_rise:.2f} GiB",
          flush=True)
    out["wss"] = {"ms_first": wss_ms, "ms": wss_ms2, "rise_gib": wss_rise,
                  "max_pa": w_pa, "accumulator_ms": acc_ms,
                  "accumulator_rise_gib": acc_rise}
    del acc, tawss, sim
    free_device()
    mark("18a (the clinical run)")
    out["coupled_counts"], out["coupled"] = clinical_coupled_path(full,
                                                                  device)
    return out


def clinical_coupled_path(full, device):
    """The clinical coronary through CoupledTransport on the kernel route
    (tools/demo_clinical_washout.py's tau_g 0.6), 2000 steps with a
    500-step bolus, every boundary recorded: the fold's K1 and its
    reduction, K8 and the record (at most four launches a step; the prime
    once a run() call)."""
    import torch

    from lbm_tpu_torch.engine.scalar import CoupledTransport
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.kernels import scalar_stream as S

    tag = "[18] clinical coupled washout"
    rec = list(range(len(full.boundaries)))
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    S.reset_launches()
    tr = CoupledTransport(full, tau_g=0.6, device=device,
                          inlet_c={0: lambda t: 1.0 if t < 500 else 0.0})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    series = tr.run(2000, record=rec)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {**K.launches, **S.launches}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    require(counts.get("lbm_scalar_stream[live]") == 2000
            and counts.get("lbm_collide_stream[bgk+wk]") == 2000
            and counts.get("lbm_windkessel_flux") == 1,
            f"{tag}: launches {counts}")
    require(bool(torch.isfinite(tr.wk).all()), f"{tag}: P_c {tr.wk}")
    ms = elapsed / 2000 * 1e3
    print(f"{tag} coronary (291, 291, 372) r=12 pulsatile [40, 2000], 4 RCR "
          f"outlets: 2000 steps in {elapsed:.3f} s = {ms:.4f} ms/step (host "
          f"clock, synchronized); P_c {tr.wk.tolist()}; peak device memory "
          f"{peak:.2f} GiB; launches {counts}", flush=True)
    check_washout(tag, tr, series, 500)
    ms2 = timed_again(tag, lambda: tr.run(1000, record=rec), 1000)
    by_name, busy = profile_steps(lambda: tr.run(200, record=rec), 200)
    print_profile(tag, by_name, busy, ms)
    del tr
    free_device()
    return counts, dict(path_profile(tag, by_name, ms, 4), ms_again=ms2)


def thermal_path(device):
    """heated_cavity_3d n=256, Ra = 1e4, Pr = 0.71: 4 chunks of 250 steps
    with nusselt_profile each, then 250 steps of the same box with TRT.
    Returns (launch counts, the TRT run's counts)."""
    import dataclasses

    import numpy as np
    import torch

    from lbm_tpu_torch.cases import thermal as tcases
    from lbm_tpu_torch.engine.thermal import BuoyantTransport
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.kernels import scalar_stream as S

    tag = "[11] thermal path"
    spec, kw, info = tcases.heated_cavity_3d(n=256, ra=1e4, pr=0.71)
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    S.reset_launches()
    bt = BuoyantTransport(spec, device=device, **kw)
    energy, nus, elapsed = [], [], 0.0
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bt.run(250)
        torch.cuda.synchronize()
        elapsed += time.perf_counter() - t0
        _, nu = bt.nusselt_profile(0, info["kappa"], info["dT"], info["H"])
        nus.append((float(np.mean(nu)), float(np.ptp(nu))))
        u = bt.macro()[1]
        energy.append(float(torch.where(bt.fluid[None], u * u, 0.0).sum(
            dtype=torch.float64)))
        del u
    torch.cuda.synchronize()
    counts = {**K.launches, **S.launches}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    require(counts.get("lbm_collide_stream[bgk+field]") == 1000
            and counts.get("lbm_scalar_stream[live+force+dirichlet]") == 1000
            and counts.get("lbm_macro", 0) >= 4,
            f"{tag}: launches {counts}")
    c = bt.concentration()
    require(bool(torch.isfinite(c).all() and torch.isfinite(bt.f).all()),
            f"{tag}: non-finite state")
    c_lo, c_hi = float(c[bt.fluid].min()), float(c[bt.fluid].max())
    require(-0.51 <= c_lo and c_hi <= 0.51,
            f"{tag}: temperature {c_lo:.4f}..{c_hi:.4f} outside the wall "
            "values +- 1e-2")
    require(energy[0] > 0 and energy[0] < energy[1] < energy[2],
            f"{tag}: kinetic energy {energy}")
    ms = elapsed / 1000 * 1e3
    print(f"{tag} heated_cavity_3d 256^3 Ra = 1e4, Pr = 0.71 ({int(bt.fluid.sum())}"
          f" fluid cells): 1000 steps in {elapsed:.3f} s = {ms:.4f} ms/step "
          "(host clock, synchronized, the Nusselt diagnostics apart), "
          f"{int(bt.fluid.sum()) / ms / 1e3:.1f} M fluid-cell updates/s; Nu "
          "(mean, plane spread) per chunk "
          f"{[(round(a, 4), round(b, 4)) for a, b in nus]}; sum u^2 per "
          f"chunk {[f'{e:.4e}' for e in energy]}; temperature "
          f"{c_lo:.4f}..{c_hi:.4f}; peak device memory {peak:.2f} GiB; "
          f"launches {counts}", flush=True)
    del c
    by_name, busy = profile_steps(lambda: bt.run(200), 200)
    print_profile(tag, by_name, busy, ms)
    del bt
    free_device()
    K.reset_launches()
    S.reset_launches()
    bt = BuoyantTransport(dataclasses.replace(spec, collision="trt"),
                          device=device, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bt.run(250)
    torch.cuda.synchronize()
    trt_ms = (time.perf_counter() - t0) / 250 * 1e3
    trt_counts = {**K.launches, **S.launches}
    require(trt_counts.get("lbm_collide_stream[trt+field]") == 250
            and bool(torch.isfinite(bt.f).all()),
            f"{tag} (trt): launches {trt_counts}")
    print(f"{tag} the same box with collision='trt': 250 steps at "
          f"{trt_ms:.4f} ms/step; launches {trt_counts}", flush=True)
    del bt
    free_device()
    return counts, trt_counts


def cli_transport_and_thermal():
    """Phase 12: the `transport` and `thermal` subcommands on the card."""
    import re

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        t0 = time.perf_counter()
        proc = cli_run(["transport", "--case", "coronary", "--flow-steps",
                        "500", "--steps", "1000", "--bolus", "200", "--vtk",
                        "--out", tmp])
        require(proc.returncode == 0,
                f"CLI transport failed ({proc.returncode}):\n{proc.stdout}\n"
                f"{proc.stderr}")
        files = sorted(os.listdir(tmp))
        require(files == ["coronary_c_1000.vtk", "coronary_washout.csv"],
                f"CLI transport outputs: {files}")
        with open(os.path.join(tmp, "coronary_washout.csv")) as fh:
            rows = fh.read().strip().splitlines()
        require(rows[0].startswith("step,bc0,bc1") and len(rows) == 1001,
                f"washout CSV: {len(rows)} lines, header {rows[0]!r}")
        lines = proc.stdout.strip().splitlines()
        print(f"[12] CLI transport (coronary default, bolus 200, --vtk) in "
              f"{time.perf_counter() - t0:.1f} s wrote {files}; "
              f"{lines[0]} | {' | '.join(l.strip() for l in lines[2:4])}",
              flush=True)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        t0 = time.perf_counter()
        proc = cli_run(["thermal", "--vtk", "--out", tmp])
        require(proc.returncode == 0,
                f"CLI thermal failed ({proc.returncode}):\n{proc.stdout}\n"
                f"{proc.stderr}")
        files = sorted(os.listdir(tmp))
        require(files == ["heated_cavity_3d_20000.vtk"],
                f"CLI thermal outputs: {files}")
        m = re.findall(r"chunk (\d): t=(\d+)  Nu=([-\d.]+) \(spread "
                       r"([-\d.]+)\)", proc.stdout)
        require(len(m) == 4 and m[-1][1] == "20000",
                f"CLI thermal output:\n{proc.stdout}")
        nu, spread = float(m[-1][2]), float(m[-1][3])
        require(1.8 < nu < 2.3,
                f"heated_cavity_3d n=32 Ra 1e4: Nu {nu} outside (1.8, 2.3)")
        print(f"[12] CLI thermal (cavity3d n=32 Ra = 1e4, Pr = 0.71, 4 x 5000 "
              f"steps, --vtk) in {time.perf_counter() - t0:.1f} s wrote "
              f"{files}: Nu {nu:.4f} beside Tric et al.'s 2.0542, plane "
              f"spread {spread:.4f}; Nu per chunk "
              f"{[float(x[2]) for x in m]}; "
              f"{proc.stdout.strip().splitlines()[-2]}", flush=True)
    return nu


def pair_cases():
    """The fused pair's comparisons (label, case, options, bit-equal to
    its plain version?): every instance a fuse=2 case can run, a series
    inlet whose phase moves inside pairs, boxes the unit (an x segment of
    64 planes of an 8 x 32 (y, z) column tile) does not fit."""
    carreau = {"model": "carreau", "nu0": 0.1, "nu_inf": 0.01,
               "lam": 100.0, "n": 0.4}
    return [
        ("lid 64^3 bgk", "lid_driven_cavity", dict(n=64), True),
        ("poiseuille 32^3", "poiseuille", dict(n=32), True),
        ("curved_vessel 64^3 series inlet, a phase every 3 steps",
         "curved_vessel", dict(n=64, nphase=4, period_steps=12), True),
        ("lid 64^3 trt", "lid_driven_cavity", dict(n=64, collision="trt"),
         True),
        ("lid 64^3 mrt", "lid_driven_cavity", dict(n=64, collision="mrt"),
         True),
        ("lid 64^3 smag 0.15", "lid_driven_cavity",
         dict(n=64, smagorinsky_cs=0.15), False),
        ("lid 64^3 moving lid", "lid_driven_cavity",
         dict(n=64, lid="bounceback"), True),
        ("poiseuille 32^3 carreau a=2", "poiseuille",
         dict(n=32, rheology=carreau), False),
        ("gravity_channel 32^3 trt+force", "gravity_channel",
         dict(n=32, nz=32, collision="trt"), True),
        ("pipe n=36 staircase bgk+force (4.5 tiles in y, 1.1 in z)", "pipe",
         dict(n=36, curved=False), True),
        ("lid 66^3 trt (two x segments, ragged tiles, z rows off 16 bytes)",
         "lid_driven_cavity", dict(n=66, collision="trt"), True),
        ("gravity_channel 20x20x3 trt+force (z shorter than a tile)",
         "gravity_channel", dict(n=20, nz=3, collision="trt"), True),
    ] + pair_instance_cases()[7:]


def pair_instance_cases():
    """One case for each of the fused pair's 14 instances (label, case,
    options, bit-equal to its plain version?), in the order bgk, trt,
    mrt, bgk+closure, bgk+moving, bgk+force, trt+force, then the seven
    that only these cases reach: a moving lid with TRT, MRT, a closure
    and a constant force, and TRT with a closure."""
    carreau = {"model": "carreau", "nu0": 0.1, "nu_inf": 0.01,
               "lam": 100.0, "n": 0.4}
    lid = dict(n=32, lid="bounceback")
    return [
        ("lid 32^3 bgk", "lid_driven_cavity", dict(n=32), True),
        ("lid 32^3 trt", "lid_driven_cavity", dict(n=32, collision="trt"),
         True),
        ("lid 32^3 mrt", "lid_driven_cavity", dict(n=32, collision="mrt"),
         True),
        ("lid 32^3 smag 0.15", "lid_driven_cavity",
         dict(n=32, smagorinsky_cs=0.15), False),
        ("lid 32^3 moving lid", "lid_driven_cavity", lid, True),
        ("pipe n=36 bgk+force", "pipe", dict(n=36, curved=False), True),
        ("gravity_channel 32^3 trt+force", "gravity_channel",
         dict(n=32, nz=32, collision="trt"), True),
        ("lid 32^3 trt moving lid", "lid_driven_cavity",
         dict(lid, collision="trt"), True),
        ("lid 32^3 mrt moving lid", "lid_driven_cavity",
         dict(lid, collision="mrt"), True),
        ("lid 32^3 smag moving lid", "lid_driven_cavity",
         dict(lid, smagorinsky_cs=0.15), False),
        ("lid 32^3 bgk+force moving lid", "lid_driven_cavity",
         dict(lid, force=(1e-5, 0.0, 0.0)), True),
        ("lid 32^3 trt+force moving lid", "lid_driven_cavity",
         dict(lid, collision="trt", force=(1e-5, 0.0, 0.0)), True),
        ("poiseuille 32^3 trt carreau", "poiseuille",
         dict(n=32, collision="trt", rheology=carreau), False),
        ("lid 32^3 trt carreau moving lid", "lid_driven_cavity",
         dict(lid, collision="trt", rheology=carreau), False),
    ]


def compare_pair(label, spec, launches, device, exact):
    """K2 against two K1 launches (bit for bit) and against its plain
    version (bit for bit when exact, else rtol 3e-6 / atol 1e-7) over
    `launches` launches from the initial state; velsums at 1e-5 relative.
    With a live-tile list, the listed launch against the full one.
    Returns the max abs error of f against the plain version."""
    import torch

    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    cc = compile_case(spec, device)
    f0 = initial_f(cc)
    n = 2 * launches
    out = {}
    for how in ("pair", "single", "plain"):
        f, buf = f0.clone(), f0.clone()
        vs = torch.zeros(n, dtype=torch.float64, device=device)
        for t in range(0, n, 2):
            if how == "pair":
                K.step2(f, buf, cc, vs, t, t)
                f, buf = buf, f
            elif how == "single":
                for k in (t, t + 1):
                    K.collide_stream(f, buf, cc, vs, k, k)
                    f, buf = buf, f
            else:
                f, vs[t], vs[t + 1] = K.collide_stream2_plain(f, cc, t)
        out[how] = (f, vs)
        del buf
    torch.cuda.synchronize()
    (fp, vp), (fs, vs1), (fq, vq) = out["pair"], out["single"], out["plain"]
    e_single = float((fp - fs).abs().max())
    require(e_single == 0.0, f"K2 {label}: differs from two K1 launches "
            f"(max abs err {e_single:.3e})")
    e_plain = check_close(f"K2 {label} vs plain", fp, fq, 3e-6, 1e-7)
    require(e_plain == 0.0 or not exact,
            f"K2 {label}: not bit-equal to its plain version ({e_plain:.3e})")
    v_rel = max(float(((vp - v).abs() / v.abs()).max()) for v in (vs1, vq))
    require(v_rel <= 1e-5, f"K2 {label}: velsum rel err {v_rel:.3e}")
    tiles = "every tile"
    if cc.live_tiles is not None:
        s = torch.zeros(4, dtype=torch.float64, device=device)
        live = K.step2(fp, torch.empty_like(fp).copy_(fp), cc, s, 0, n)
        full = K.step2(fp, torch.empty_like(fp).copy_(fp), cc, s, 2, n,
                       all_tiles=True)
        torch.cuda.synchronize()
        require(torch.equal(live, full) and torch.allclose(
            s[:2], s[2:], rtol=1e-12, atol=0.0),
            f"K2 {label}: the live-tile launch differs from the full one")
        tiles = f"{cc.live_tiles.numel()} live tiles, equal to the full launch"
    print(f"[3] K2 [{K.instance(cc)}] {label}: {launches} launches ({n} "
          f"steps), max abs err vs two K1 launches {e_single:.3e}, vs plain "
          f"{e_plain:.3e}; velsum max rel err {v_rel:.3e}; {tiles}",
          flush=True)
    del out, fp, fs, fq, f0
    free_device()
    return e_plain


def time_pair(spec, device, iters, label):
    """One K2 launch of the case's instance against two K1 launches (in
    turns) and against the plain pair, with the bound: the bytes of one
    step (a pair reads and writes the state once). {"ms", "two_k1_ms",
    "plain_ms", "bound_ms", "instance"}."""
    import torch

    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    cc = compile_case(spec, device)
    state = [initial_f(cc), initial_f(cc)]
    series = torch.zeros(2, dtype=torch.float64, device=device)

    def pair():
        K.step2(state[0], state[1], cc, series, 0, 0)
        state.reverse()

    def two_k1():
        for k in (0, 1):
            K.collide_stream(state[0], state[1], cc, series, k, k)
            state.reverse()

    inst = K.instance(cc)
    ms, two_ms = in_turns(f"K2 [{inst}] {label}", two_k1, pair, iters,
                          iters, names="two K1 launches/K2")
    plain_ms = time_ms(lambda: K.collide_stream2_plain(state[0], cc, 0), 4)
    out = {"ms": ms, "two_k1_ms": two_ms, "plain_ms": plain_ms,
           "instance": inst,
           "bound_ms": bound_ms(step_bytes(cc, cc.fluid, cc.kernel_bcs))}
    print(f"[3] K2 [{inst}] {label}: {ms:.4f} ms a launch (two steps) "
          f"against two K1 launches {two_ms:.4f} ms, the plain pair "
          f"{plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms", flush=True)
    del state
    free_device()
    return out


def time_pair_developed(f, cc, label, iters=100):
    """One K2 launch against two K1 launches, in turns, from copies of a
    run's state f (after 1000 steps the IEEE division's slow path, which
    the resting state sends many cells down, is rare): (K2 ms, two K1
    ms)."""
    import torch

    from lbm_tpu_torch.kernels import collide_stream as K

    state = [f.clone(), f.clone()]
    series = torch.zeros(2, dtype=torch.float64, device=f.device)

    def pair():
        K.step2(state[0], state[1], cc, series, 0, 1000)
        state.reverse()

    def two_k1():
        for k in (0, 1):
            K.collide_stream(state[0], state[1], cc, series, k, 1000 + k)
            state.reverse()

    out = in_turns(label, two_k1, pair, iters, iters,
                   names="two K1 launches/K2")
    del state
    free_device()
    return out


def compare_rows(device):
    """K4 against extract_rows_plain, chunk by chunk, on lid 256^3 after
    20 steps (chunks of chunk_rows x rows and a ragged last one).
    Returns the max abs error."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import collide_stream as K

    spec = get_case("lid_driven_cavity", n=256)
    sim = Simulation(spec, device=device)
    sim.run(max_steps=20, time_save=20, verbose=False)
    rows, nx = K.chunk_rows(spec.shape), spec.shape[0]
    err = 0.0
    for x0 in range(0, nx, rows):
        w = min(rows, nx - x0)
        got = K.extract_rows(sim.f, x0, w)
        err = max(err, float((got - K.extract_rows_plain(sim.f, x0, w))
                             .abs().max()))
    require(err == 0.0, f"K4 on lid 256^3: max abs err {err:.3e}")
    print(f"[3] K4 lid 256^3 after 20 steps, chunks of {rows} x rows: "
          f"bit-equal to extract_rows_plain", flush=True)
    del sim
    free_device()
    return err


def fuse2_path(device, lid1):
    """Phase 13: Simulation(lid_driven_cavity n=256, fuse=2), 1000 steps
    at time_save=250 (K2 500, K1 0), then 999 steps at time_save=333
    (K2 498, K1 3); velsum series and macro() against phase 4's fuse=1
    run (lid1: its velsum series, ms/step, peak GiB, rho and u)."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import collide_stream as K

    tag = "[13] fuse2 path"
    spec = get_case("lid_driven_cavity", n=256)
    held = torch.cuda.memory_allocated(device)  # phase 4's f, rho and u
    sim = Simulation(spec, device=device, fuse=2)
    require(sim.cc.live_tiles is None,
            f"{tag}: the lid cavity launches K2 with a tile list")
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    res = sim.run(max_steps=1000, time_save=250, verbose=False)
    rho, u = sim.macro()
    torch.cuda.synchronize()
    counts = dict(K.launches)
    peak = (torch.cuda.max_memory_allocated(device) - held) / 2**30
    require(counts.get("lbm_collide_stream2[bgk]") == 500
            and "lbm_collide_stream[bgk]" not in counts,
            f"{tag}: launches {counts} in 1000 steps")
    require(res.steps == 1000, f"{tag}: {res.steps} steps")
    vs, vs1 = res.velsum_series, lid1["velsum"]
    v_rel = float(abs(vs - vs1).max() / abs(vs1).min())
    e_rho, e_u = rel_l2(rho, lid1["rho"]), rel_l2(u, lid1["u"])
    f_equal = bool(torch.equal(sim.f, lid1["f"]))
    require(v_rel <= 1e-5 and e_rho <= 1e-5 and e_u <= 1e-5 and f_equal,
            f"{tag}: against fuse=1 velsum rel {v_rel:.3e}, macro() rel L2 "
            f"rho {e_rho:.3e} u {e_u:.3e}, f bit-equal {f_equal}")
    ms = res.elapsed_s / res.steps * 1e3
    print(f"{tag} lid 256^3 fuse=2: 1000 steps in {res.elapsed_s:.3f} s = "
          f"{ms:.4f} ms/step (host clock, synchronized) against fuse=1's "
          f"{lid1['ms']:.4f} (phase 4), mlups_box {res.mlups_box:.1f} "
          f"against {lid1['mlups_box']:.1f}; peak device memory {peak:.2f} "
          f"GiB against {lid1['peak']:.2f}; velsum series max rel err "
          f"{v_rel:.3e} against fuse=1, macro() rel L2 rho {e_rho:.3e} u "
          f"{e_u:.3e}, f bit-equal to fuse=1's: {f_equal}; launches "
          f"{counts}", flush=True)
    del rho, u
    dev_ms, dev_two_ms = time_pair_developed(
        sim.f, sim.cc, "K2 [bgk] lid 256^3 after the 1000 fuse=2 steps")
    by_name, busy = profile_run(sim, 200)
    print_profile(tag, by_name, busy, ms)
    k2_dev = [v[0] / v[1] for k, v in by_name.items()
              if "collide_stream2_kernel" in k]
    sim.reset()
    K.reset_launches()
    res = sim.run(max_steps=999, time_save=333, verbose=False)
    torch.cuda.synchronize()
    odd = dict(K.launches)
    require(odd.get("lbm_collide_stream2[bgk]") == 498
            and odd.get("lbm_collide_stream[bgk]") == 3,
            f"{tag}: launches {odd} in 999 steps at time_save=333")
    v_odd = float(abs(res.velsum_series - vs1[:999]).max() / abs(vs1).min())
    require(v_odd <= 1e-5, f"{tag}: odd chunks' velsum rel err {v_odd:.3e}")
    print(f"{tag} 999 steps at time_save=333 (166 pairs and one K1 step a "
          f"chunk): {res.elapsed_s / 999 * 1e3:.4f} ms/step; velsum max rel "
          f"err {v_odd:.3e} against fuse=1; launches {odd}", flush=True)
    del sim
    free_device()
    return counts, odd, {"ms_step": ms, "peak": peak,
                         "k2_device_ms": k2_dev[0] if k2_dev else None,
                         "busy": busy, "k2_developed_ms": dev_ms,
                         "two_k1_developed_ms": dev_two_ms}


def bf16_cases():
    """Phase 3d's bf16 comparisons (label, case, options, bit-equal to the
    plain version?): the bf16 collide-stream branches, and its bf16 z
    planes on the pulsatile small coronary. The closures
    (Smagorinsky, Carreau) compute transcendentals that round differently
    on the card in fp32, so a narrowing may differ by a bf16 ulp: they are
    held at BF16_REL of max |f|."""
    carreau = {"model": "carreau", "nu0": 0.1, "nu_inf": 0.01,
               "lam": 100.0, "n": 0.4}
    return [
        ("lid 64^3 bgk", "lid_driven_cavity", dict(n=64), True),
        ("lid 64^3 trt", "lid_driven_cavity", dict(n=64, collision="trt"),
         True),
        ("lid 64^3 mrt", "lid_driven_cavity", dict(n=64, collision="mrt"),
         True),
        ("lid 64^3 smag 0.15", "lid_driven_cavity",
         dict(n=64, smagorinsky_cs=0.15), False),
        ("lid 64^3 moving lid", "lid_driven_cavity",
         dict(n=64, lid="bounceback"), True),
        ("poiseuille 32^3 carreau a=2", "poiseuille",
         dict(n=32, rheology=carreau), False),
        ("gravity_channel 32^3 trt+force", "gravity_channel",
         dict(n=32, nz=32, collision="trt"), True),
        ("pipe n=36 staircase bgk+force", "pipe", dict(n=36, curved=False),
         True),
        ("coronary (64,48,96) r=4 pulsatile, bf16 z planes", "coronary",
         dict(shape=[64, 48, 96], radius=4, pulsatile=[4, 40]), True),
        # the paired kernel's edges: an odd nz (a last z cell alone, rows
        # starting at odd elements) with z planes on even halves of their
        # pairs; an odd cell count (every direction at the other parity)
        ("coronary (64,48,95) r=4 pulsatile, odd nz", "coronary",
         dict(shape=[64, 48, 95], radius=4, pulsatile=[4, 40]), True),
        ("gravity_channel 23x23x25 trt+force, odd cell count",
         "gravity_channel", dict(n=23, nz=25, fz=1e-4, collision="trt"),
         True),
    ]


def compare_bf16(label, spec, steps, device, exact):
    """A bf16 instance against its plain version on bf16 state: the whole
    step (one K1 launch, its bf16 z planes included) for `steps` steps,
    then K1 alone (against step_plain) and K3 (with the case's force
    shift) on the result. exact: f bit for bit; else within BF16_REL of
    max |f|. K3 bit for bit; velsums at 1e-5 relative. Returns {"f",
    "k1a", "z", "k3", "n_diff", "instance"} (max abs errors, "z" K1's on
    a case with z planes; values of f that differ after `steps`
    steps)."""
    import torch

    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    cc = compile_case(spec, device)
    inst = K.instance(cc) + "+bf16"
    f0 = initial_f(cc).to(torch.bfloat16)
    fk, buf, fp = f0.clone(), f0.clone(), f0
    vs_k = torch.zeros(steps, dtype=torch.float64, device=device)
    vs_p = torch.zeros(steps, dtype=torch.float64, device=device)
    for t in range(steps):
        K.step(fk, buf, cc, vs_k, t, t)
        fk, buf = buf, fk
        fp, vs_p[t] = K.step_plain(fp, cc, t)
    torch.cuda.synchronize()
    require(fk.dtype == fp.dtype == torch.bfloat16, f"{label}: not bf16")

    def err(a, b, what):
        e = float((a.float() - b.float()).abs().max())
        lim = 0.0 if exact else BF16_REL * float(b.float().abs().max())
        require(e <= lim and bool(torch.isfinite(a).all()),
                f"bf16 {what} {label}: max abs err {e:.3e} > {lim:.3e}")
        return e

    e_f = err(fk, fp, f"step f after {steps} steps")
    n_diff = int((fk != fp).sum())
    vs_rel = float(((vs_k - vs_p).abs() / vs_p.abs()).max())
    require(vs_rel <= 1e-5, f"bf16 step velsum {label}: rel {vs_rel:.3e}")
    t = steps
    s = torch.zeros(1, dtype=torch.float64, device=device)
    out_p, v_p = K.step_plain(fk, cc, t)
    e_k1 = err(K.collide_stream(fk, buf, cc, s, 0, t), out_p, "K1a alone")
    require(abs(float(s[0] - v_p)) <= 1e-5 * abs(float(v_p)),
            f"bf16 K1a velsum {label}")
    e_z = e_k1 if cc.z_bcs else 0.0
    # the pair list's launch (interior pairs first) against the box's
    all_k = K.collide_stream(fk, torch.empty_like(fk).copy_(fk), cc, s, 0,
                             t, all_blocks=True)
    require(torch.equal(all_k, buf),
            f"bf16 pair-list launch differs from the box's, {label}")
    rho_k, u_k = K.macro(fk, cc.force)
    rho_p, u_p = K.macro_plain(fk, cc.force)
    e_m = max(float((rho_k - rho_p).abs().max()),
              float((u_k - u_p).abs().max()))
    require(e_m == 0.0, f"bf16 K3 {label}: max abs err {e_m:.3e}")
    print(f"[3d] bf16 [{inst}] {label}: step f max abs err {e_f:.3e} "
          f"({n_diff} of {fk.numel()} values differ) after {steps} steps, "
          f"velsum max rel err {vs_rel:.3e}; K1a alone {e_k1:.3e} "
          f"({len(cc.z_bcs)} z planes in its launch); K3 {e_m:.3e}",
          flush=True)
    _, _, cf = K.collision_descriptor(cc)
    divisors = {float(cf[K.CFLOAT[k]]) for k in ("tau", "two_tau",
                                                 "two_tau_m")}
    del fk, buf, fp, out_p
    free_device()
    return {"f": e_f, "k1a": e_k1, "z": e_z, "k3": e_m, "n_diff": n_diff,
            "instance": inst, "divisors": divisors - {0.0}}


def div_exact_sweeps(divisors, device) -> dict:
    """The paired bf16 kernel's division against IEEE a / b over all 2^32
    fp32 dividends for each divisor (K.div_exact_check): every quotient
    bit for bit (NaN matching NaN) and the host's reciprocal equal to
    __frcp_rn. Returns {divisor: mismatches}, all 0."""
    import numpy as np

    from lbm_tpu_torch.kernels import collide_stream as K

    t0 = time.perf_counter()
    bad = {}
    for b in divisors:
        n_bad, rcp_equal = K.div_exact_check(b, device)
        bad[float(np.float32(b))] = n_bad
        require(n_bad == 0 and rcp_equal,
                f"div_exact by {b!r}: {n_bad} of 2^32 quotients differ "
                f"from a / b, reciprocal equal {rcp_equal}")
    print(f"[3d] div_exact against IEEE a / b over all 2^32 fp32 dividends "
          f"(NaN matched as NaN), mismatches per divisor: "
          + "; ".join(f"{b!r} {n}" for b, n in bad.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return bad


def compare_pair_bf16(label, spec, launches, device, exact=True):
    """K2 on bf16 state against its plain version (widen, two fp32 steps,
    narrow) over `launches` launches, bit for bit when exact (a closure,
    whose fp32 transcendentals round differently on the card, within
    BF16_REL of max |f|), velsums at 1e-5; with a
    live-tile list, the listed launch against the full one. Against two
    bf16 K1 launches (which narrow in between) it prints how many values
    differ and by how much, without a gate. Returns (max abs err against
    plain, values differing from two K1 launches, their max abs
    difference)."""
    import torch

    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    cc = compile_case(spec, device)
    f0 = initial_f(cc).to(torch.bfloat16)
    n = 2 * launches
    out = {}
    for how in ("pair", "single", "plain"):
        f, buf = f0.clone(), f0.clone()
        vs = torch.zeros(n, dtype=torch.float64, device=device)
        for t in range(0, n, 2):
            if how == "pair":
                K.step2(f, buf, cc, vs, t, t)
                f, buf = buf, f
            elif how == "single":
                for k in (t, t + 1):
                    K.collide_stream(f, buf, cc, vs, k, k)
                    f, buf = buf, f
            else:
                f, vs[t], vs[t + 1] = K.collide_stream2_plain(f, cc, t)
        out[how] = (f, vs)
        del buf
    torch.cuda.synchronize()
    (fp, vp), (fs, _), (fq, vq) = out["pair"], out["single"], out["plain"]
    e_plain = float((fp.float() - fq.float()).abs().max())
    bound = 0.0 if exact else BF16_REL * float(fq.float().abs().max())
    require(e_plain <= bound and bool(torch.isfinite(fp).all()),
            f"bf16 K2 {label}: {e_plain:.3e} from its plain version, over "
            f"{bound:.3e}")
    v_rel = float(((vp - vq).abs() / vq.abs()).max())
    require(v_rel <= 1e-5, f"bf16 K2 {label}: velsum rel err {v_rel:.3e}")
    n_single = int((fp != fs).sum())
    e_single = float((fp.float() - fs.float()).abs().max())
    tiles = "every tile"
    if cc.live_tiles is not None:
        s = torch.zeros(4, dtype=torch.float64, device=device)
        live = K.step2(fp, torch.empty_like(fp).copy_(fp), cc, s, 0, n)
        full = K.step2(fp, torch.empty_like(fp).copy_(fp), cc, s, 2, n,
                       all_tiles=True)
        torch.cuda.synchronize()
        require(torch.equal(live, full) and torch.allclose(
            s[:2], s[2:], rtol=1e-12, atol=0.0),
            f"bf16 K2 {label}: the live-tile launch differs from the full "
            "one")
        tiles = f"{cc.live_tiles.numel()} live tiles, equal to the full launch"
    print(f"[3d] bf16 K2 [{K.instance(cc)}+bf16] {label}: {launches} "
          f"launches ({n} steps), max abs err {e_plain:.3e} against the "
          f"plain pair (one narrowing a pair), velsum max rel err {v_rel:.3e}; against two bf16 K1 "
          f"launches a step (a narrowing a step) {n_single} of {fp.numel()} "
          f"values differ, max abs {e_single:.3e}; {tiles}", flush=True)
    del out, fp, fs, fq, f0
    free_device()
    return e_plain, n_single, e_single


def time_pair_bf16(spec, device, iters, label):
    """One bf16 K2 launch against its plain pair and two bf16 K1 launches
    (in turns), with the bound of one bf16 step's bytes. {"ms",
    "two_k1_ms", "plain_ms", "bound_ms", "instance"}."""
    import torch

    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    cc = compile_case(spec, device)
    f0 = initial_f(cc).to(torch.bfloat16)
    state = [f0, f0.clone()]
    series = torch.zeros(2, dtype=torch.float64, device=device)

    def pair():
        K.step2(state[0], state[1], cc, series, 0, 0)
        state.reverse()

    def two_k1():
        for k in (0, 1):
            K.collide_stream(state[0], state[1], cc, series, k, k)
            state.reverse()

    inst = K.instance(cc) + "+bf16"
    ms, two_ms = in_turns(f"K2 [{inst}] {label}", two_k1, pair, iters,
                          iters, names="two K1 launches/K2")
    plain_ms = time_ms(lambda: K.collide_stream2_plain(state[0], cc, 0), 4)
    out = {"ms": ms, "two_k1_ms": two_ms, "plain_ms": plain_ms,
           "instance": inst,
           "bound_ms": bound_ms(step_bytes(cc, cc.fluid, cc.kernel_bcs, 2))}
    print(f"[3d] K2 [{inst}] {label}: {ms:.4f} ms a launch (two steps) "
          f"against two bf16 K1 launches {two_ms:.4f} ms, the plain pair "
          f"{plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms", flush=True)
    del state
    free_device()
    return out


def bf16_lid_path(device, lid1, fuse):
    """Phase 15a/15c: Simulation(lid_driven_cavity n=256,
    store_dtype='bf16', fuse=fuse), 1000 steps at time_save=250, counters
    reset just before and read just after (fuse 1: K1a [bgk+bf16] 1000;
    fuse 2: K2 [bgk+bf16] 500 and no K1a), macro() (K3 [bf16]); ms/step
    beside phase 4's fp32 run (lid1), MLUPS against the bf16 ceiling (76
    B a cell at 3.35 TB/s), macro() u against phase 4's at relative L2.
    Returns the counts and metrics, the velsum series and u among them."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import collide_stream as K

    tag = "[15] bf16 lid path" if fuse == 1 else "[15] bf16 fuse2 path"
    spec = get_case("lid_driven_cavity", n=256)
    held = torch.cuda.memory_allocated(device)
    sim = Simulation(spec, device=device, fuse=fuse, store_dtype="bf16")
    require(sim.f.dtype == torch.bfloat16 and sim.cc.live_blocks is None,
            f"{tag}: state {sim.f.dtype}, block list "
            f"{sim.cc.live_blocks is not None}")
    torch.cuda.reset_peak_memory_stats(device)
    marks = []
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(max_steps=1000, time_save=250, verbose=False,
                  on_save=chunk_clock(marks))
    rho, u = sim.macro()
    torch.cuda.synchronize()
    counts = dict(K.launches)
    peak = (torch.cuda.max_memory_allocated(device) - held) / 2**30
    if fuse == 1:
        require(counts.get("lbm_collide_stream[bgk+bf16]") == 1000,
                f"{tag}: launches {counts} in 1000 steps")
    else:
        require(counts.get("lbm_collide_stream2[bgk+bf16]") == 500
                and not any(k.startswith("lbm_collide_stream[")
                            for k in counts),
                f"{tag}: launches {counts} in 1000 steps")
    require(counts.get("lbm_macro[bf16]", 0) >= 1,
            f"{tag}: macro() did not launch K3 [bf16]")
    require(res.steps == 1000 and bool(torch.isfinite(rho).all()
                                       and torch.isfinite(u).all()),
            f"{tag}: {res.steps} steps, finite fields "
            f"{bool(torch.isfinite(u).all())}")
    u_lid = 0.15 / 2.4705
    fluid = sim.cc.fluid
    u_max = float(u.norm(dim=0)[fluid].max())
    require(u_max <= 2.0 * u_lid, f"{tag}: max|u| {u_max:.4g}")
    ms = res.elapsed_s / res.steps * 1e3
    ceiling = HBM_BYTES_PER_S / 76 / 1e6
    e_u, e_rho = rel_l2(u, lid1["u"]), rel_l2(rho, lid1["rho"])
    e_driven, e_bulk = lid_drift_split(u, lid1["u"], fluid)
    vs = res.velsum_series
    v_rel = float(abs(vs - lid1["velsum"]).max() / abs(lid1["velsum"]).min())
    print(f"{tag} lid 256^3 bf16 fuse={fuse}: 1000 steps in "
          f"{res.elapsed_s:.3f} s = {ms:.4f} ms/step (host clock, "
          f"synchronized; chunks of 250: {chunk_ms(t0, marks, 250)}) against "
          f"phase 4's fp32 {lid1['ms']:.4f} ({lid1['chunks']}); mlups_box "
          f"{res.mlups_box:.1f} against the bf16 ceiling {ceiling:.1f} (76 B "
          f"a cell at 3.35 TB/s; fp32 {lid1['mlups_box']:.1f}); macro() "
          f"against phase 4's fp32 run: rel L2 u {e_u:.3e} (the driven rows "
          f"within 32 of the lid {e_driven:.3e}, the resting bulk "
          f"{e_bulk:.3e}), rho {e_rho:.3e}; "
          f"velsum series max rel diff {v_rel:.3e}; max|u| {u_max:.4g}; "
          f"peak device memory {peak:.2f} GiB against fp32's "
          f"{lid1['peak']:.2f}; launches {counts}", flush=True)
    out = {"counts": counts, "ms": ms, "mlups_box": res.mlups_box,
           "rel_l2_u": e_u, "rel_l2_u_driven": e_driven,
           "rel_l2_u_bulk": e_bulk, "peak": peak, "velsum": vs, "u": u}
    if fuse == 2:
        out["k2_developed_ms"], out["two_k1_developed_ms"] = \
            time_pair_developed(sim.f, sim.cc, "K2 [bgk+bf16] lid 256^3 "
                                "after the 1000 bf16 fuse=2 steps")
    by_name, busy = profile_run(sim, 200)
    print_profile(tag, by_name, busy, ms)
    out["busy"] = busy
    del sim, rho, fluid
    free_device()
    return out


def lowmem_read(device, store_dtype, tag):
    """lid_driven_cavity 512^3 (lowmem by its size) in `store_dtype`, 20
    steps, then f_standard() through K4 (counters reset just before and
    read just after): every chunk against f.narrow().cpu() (widened) bit
    for bit, device memory up by at most one chunk; K4 per chunk against
    its plain version and narrow().contiguous(). Returns the K4 and read
    numbers."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import collide_stream as K

    t0 = time.perf_counter()
    spec = get_case("lid_driven_cavity", n=512)
    sim = Simulation(spec, device=device, store_dtype=store_dtype)
    t_setup = time.perf_counter() - t0
    require(sim.lowmem, f"{tag}: 512^3 did not switch lowmem on")
    res = sim.run(max_steps=20, time_save=20, verbose=False)
    torch.cuda.synchronize()
    elem = sim.f.element_size()
    state_gb = sim.f.numel() * elem / 1e9
    avail = mem_available_gb()
    require(avail > 1.5 * sim.f.numel() * 4 / 1e9,
            f"{tag}: host MemAvailable {avail:.1f} GB cannot hold the "
            f"{sim.f.numel() * 4 / 1e9:.1f} GB float32 state")
    free_device()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    t0 = time.perf_counter()
    host = sim.f_standard()
    seconds = time.perf_counter() - t0
    counts = dict(K.launches)
    rise = torch.cuda.max_memory_allocated(device) - before
    rows = K.chunk_rows(spec.shape)
    n_chunks = -(-spec.shape[0] // rows)
    chunk_bytes = 19 * rows * spec.shape[1] * spec.shape[2] * elem
    k4 = "lbm_extract_rows[bf16]" if elem == 2 else "lbm_extract_rows"
    require(counts == {k4: n_chunks},
            f"{tag}: launches {counts}, {n_chunks} chunks")
    require(rise <= K.CHUNK_BYTES,
            f"{tag}: device memory rose by {rise} B during the read")
    require(host.device.type == "cpu" and host.dtype == torch.float32
            and tuple(host.shape) == (19,) + tuple(spec.shape),
            f"{tag}: host state {host.dtype} {tuple(host.shape)}")
    for x0 in range(0, spec.shape[0], rows):
        w = min(rows, spec.shape[0] - x0)
        require(torch.equal(host[:, x0:x0 + w],
                            sim.f.narrow(1, x0, w).cpu().float()),
                f"{tag}: chunk at x0={x0} differs from the state")
    require(bool(torch.isfinite(host[:, ::64]).all()), f"{tag}: non-finite")
    del host
    gc.collect()
    print(f"{tag} lid 512^3 {sim.f.dtype} (2 x {state_gb:.2f} GB state; "
          f"set-up {t_setup:.1f} s; 20 steps at "
          f"{res.elapsed_s / 20 * 1e3:.4f} ms/step): f_standard() in "
          f"{seconds:.3f} s = {state_gb / seconds:.2f} GB/s of state "
          f"through {n_chunks} chunks of {rows} x rows ({chunk_bytes / 1e6:.1f}"
          f" MB); every chunk bit-equal to f.narrow().cpu(); device memory "
          f"rose by {rise / 1e6:.1f} MB during the read; host MemAvailable "
          f"{avail:.1f} GB before it; launches {counts}", flush=True)

    f = sim.f
    out = torch.empty((19, rows) + tuple(spec.shape[1:]), dtype=f.dtype,
                      device=device)
    x0 = spec.shape[0] // 2
    ms, plain_ms = in_turns(
        f"K4 {f.dtype} lid 512^3, one {rows}-row chunk",
        lambda: K.extract_rows_plain(f, x0, rows),
        lambda: K.extract_rows(f, x0, rows, out=out), 50, 50)
    library_ms = time_ms(lambda: f.narrow(1, x0, rows).contiguous(), 50)
    err = float((K.extract_rows(f, x0, rows, out=out).float()
                 - f.narrow(1, x0, rows).float()).abs().max())
    require(err == 0.0, f"{tag}: K4 chunk differs from narrow() ({err})")
    k4_numbers = {"launches": counts.get(k4, 0), "max_abs_err": err,
                  "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms(2 * chunk_bytes), "read_s": seconds,
                  "read_gb_per_s": state_gb / seconds,
                  "device_rise_mb": rise / 1e6,
                  "chunk_mb": chunk_bytes / 1e6,
                  "steps_ms": res.elapsed_s / 20 * 1e3}
    print(f"{tag} K4 per {chunk_bytes / 1e6:.1f} MB chunk: {ms:.4f} ms, "
          f"plain {plain_ms:.4f}, narrow().contiguous() {library_ms:.4f}, "
          f"bound {k4_numbers['bound_ms']:.4f} ms", flush=True)
    del sim, f, out
    free_device()
    return k4_numbers


def mem_available_gb() -> float:
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise SmokeFailure("no MemAvailable in /proc/meminfo")


def lowmem_path(device):
    """Phase 14: lid_driven_cavity 512^3 (lowmem by its size), 20 steps,
    then f_standard() through K4: every chunk against f.narrow().cpu()
    bit for bit, device memory up by at most one chunk; K4 per chunk
    against its plain version and narrow().contiguous(). Then a lowmem
    save -> restore -> 2 steps round trip on a small pulsatile coronary,
    bit-equal to an uninterrupted run. Returns the K4 numbers."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine import checkpoint as ckpt
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import collide_stream as K

    tag = "[14] lowmem path"
    k4 = lowmem_read(device, None, tag)

    spec = get_case("coronary", shape=[64, 48, 96], radius=4,
                    pulsatile=[4, 40])
    a = Simulation(spec, device=device, lowmem=True)
    b = Simulation(spec, device=device, lowmem=True)
    a.run(max_steps=10, time_save=10, verbose=False)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "coronary.ckpt.npz")
        ckpt.save_sim(path, a)
        ckpt.restore(b, path)
    a.run(max_steps=2, time_save=2, verbose=False)
    b.run(max_steps=2, time_save=2, verbose=False)
    torch.cuda.synchronize()
    require(b.t == 12 and torch.equal(a.f, b.f),
            f"{tag}: the lowmem save -> restore -> 2 steps round trip "
            "differs from the uninterrupted run")
    print(f"{tag} coronary (64, 48, 96) r=4 pulsatile, lowmem forced: save "
          "-> restore -> 2 steps bit-equal to the uninterrupted run",
          flush=True)
    del a, b
    free_device()
    return k4


def halo_cases():
    """The collision branches phase 3e holds K1d against its plain version
    and the whole-box step on: (label, case, options, shard axis,
    bit-equal?), every fp32 instance but the force field's on x or y."""
    carreau = {"model": "carreau", "nu0": 0.1, "nu_inf": 0.01,
               "lam": 100.0, "n": 0.4}
    small = dict(shape=[64, 48, 96], radius=4, pulsatile=[4, 40])
    return [
        ("lid 64^3 bgk on x", "lid_driven_cavity", dict(n=64), 0, True),
        ("coronary (64,48,96) pulsatile bgk on y", "coronary", small, 1,
         True),
        ("lid 64^3 trt on x", "lid_driven_cavity",
         dict(n=64, collision="trt"), 0, True),
        ("coronary (64,48,96) trt on y", "coronary",
         dict(small, collision="trt"), 1, True),
        ("lid 64^3 mrt on x", "lid_driven_cavity",
         dict(n=64, collision="mrt"), 0, True),
        ("coronary (64,48,96) mrt on y", "coronary",
         dict(small, collision="mrt"), 1, True),
        ("lid 64^3 moving lid on x", "lid_driven_cavity",
         dict(n=64, lid="bounceback"), 0, True),
        ("lid 64^3 trt moving lid on y", "lid_driven_cavity",
         dict(n=64, lid="bounceback", collision="trt"), 1, True),
        ("gravity_channel 32^3 bgk+force on x", "gravity_channel",
         dict(n=32, nz=32), 0, True),
        ("gravity_channel 32^3 trt+force on y", "gravity_channel",
         dict(n=32, nz=32, collision="trt"), 1, True),
        ("lid 64^3 smag 0.15 on x", "lid_driven_cavity",
         dict(n=64, smagorinsky_cs=0.15), 0, False),
        ("poiseuille 32^3 carreau on x", "poiseuille",
         dict(n=32, rheology=carreau), 0, False),
        ("coronary (64,48,96) trt+carreau on y", "coronary",
         dict(small, collision="trt", rheology=carreau), 1, False),
    ]


def compare_halo(label, spec, axis, world, steps, device, exact):
    """K1d (its z planes in the launch) on `world` shards held in one
    process for `steps` steps from the initial state: each shard's step
    against the plain halo step, and the stitched shards against the
    whole-box kernel step; the shards' velsums against the whole box's. exact: both bit for bit (else rtol 3e-6, atol 1e-7). Returns
    the max abs error of the two comparisons."""
    import torch

    from lbm_tpu_torch.bridge import gather_windows, shard_window
    from lbm_tpu_torch.engine.compile import compile_case, compile_shard
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.parallel.halo import ring_planes

    cc = compile_case(spec, device)
    ccs = [compile_shard(spec, r, world, axis, device) for r in range(world)]
    f = initial_f(cc)
    whole, buf = f, f.clone()
    fk = [shard_window(f, r, world, axis) for r in range(world)]
    bufs = [x.clone() for x in fk]
    fp = [x.clone() for x in fk]
    vk = torch.zeros(world, steps, dtype=torch.float64, device=device)
    vp = torch.zeros(world, steps, dtype=torch.float64, device=device)
    vw = torch.zeros(steps, dtype=torch.float64, device=device)
    K.reset_launches()
    for t in range(steps):
        K.step(whole, buf, cc, vw, t, t)
        whole, buf = buf, whole
        planes_k, planes_p = ring_planes(fk, axis), ring_planes(fp, axis)
        for r, c in enumerate(ccs):
            K.step(fk[r], bufs[r], c, vk[r], t, t, halo=c.halo(*planes_k[r]))
            fk[r], bufs[r] = bufs[r], fk[r]
            fp[r], vp[r, t] = K.step_plain(fp[r], c, t,
                                           halo=c.halo(*planes_p[r]))
    torch.cuda.synchronize()
    inst = K.instance(cc)
    n_z = sum(bc.window is not None for c in ccs for bc in c.z_bcs)
    counts = dict(K.launches)
    # each shard's K1d, over its fluid cells where it has a list
    want = [K.counter_name(c, halo=True) for c in ccs]
    require(all(counts.get(k) == steps * want.count(k) for k in want)
            and not [k for k in counts if "fix_z_plane" in k],
            f"K1d {label}, {world} shards: launches {counts}")
    tag = f"K1d {label}, {world} shards of {tuple(ccs[0].shape)}"
    e_plain = max(check_close(f"{tag}: shard {r} against its plain version",
                              fk[r], fp[r], 3e-6, 1e-7)
                  for r in range(world))
    stitched = gather_windows(fk, axis, spec.shape[axis])
    e_whole = check_close(f"{tag}: stitched against the whole box", stitched,
                          whole, 3e-6, 1e-7)
    if exact:
        require(e_plain == e_whole == 0.0,
                f"{tag}: not bit-equal (plain {e_plain:.3e}, whole box "
                f"{e_whole:.3e})")
    vs_rel = float(((vk.sum(0) - vw).abs() / vw.abs()).max())
    vp_rel = float(((vk - vp).abs() / vp.abs().clamp_min(1e-300)).max())
    require(vs_rel <= 1e-5 and vp_rel <= 1e-5,
            f"{tag}: velsum rel err {vs_rel:.3e} against the whole box, "
            f"{vp_rel:.3e} against plain")
    print(f"[3e] {tag} ({inst}+halo, {n_z} z windows): after {steps} steps "
          f"max abs err {e_plain:.3e} against plain, {e_whole:.3e} against "
          f"the whole-box step; velsum rel err {vs_rel:.3e}", flush=True)
    del whole, buf, fk, bufs, fp, stitched
    free_device()
    return max(e_plain, e_whole)


def time_halo(spec, axis, world, device, label):
    """K1d on the rank with the most live blocks of `world` shards of spec:
    per launch by CUDA events in turns against its plain version and
    against K1a on the same local shape and live list (the whole-box
    kernel, wrapping where K1d reads the planes), and, where the shard
    holds z-plane windows, by the profiler's device time with its z
    planes against without them (what the z planes cost in the launch,
    beside their plain fixups). Bounds: the local step's bytes
    (step_bytes) plus the two planes and their labels read, over 3.35
    TB/s."""
    import dataclasses

    import torch

    from lbm_tpu_torch.engine.compile import compile_shard
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.parallel.halo import ring_planes

    ccs = [compile_shard(spec, r, world, axis, device) for r in range(world)]
    rank = max(range(world), key=lambda r: 0 if ccs[r].live_blocks is None
               else ccs[r].live_blocks.numel())
    cc = ccs[rank]
    del ccs
    f = initial_f(cc)
    state = [f, f.clone()]
    halo = cc.halo(*ring_planes([f], axis)[0])
    series = torch.zeros(1, dtype=torch.float64, device=device)

    def k1d():
        K.collide_stream(state[0], state[1], cc, series, 0, 0, halo=halo)
        state.reverse()

    def k1a():
        K.collide_stream(state[0], state[1], cc, series, 0, 0)
        state.reverse()

    def plain():
        K.step_plain(state[0], cc, 0, halo=halo)

    lat = [n for a, n in enumerate(cc.shape) if a != axis]
    planes = 2 * (5 * 4 + 1) * lat[0] * lat[1]
    tag = f"{label} rank {rank} of {world}, local {tuple(cc.shape)}"
    iters = 1000 if cc.live_blocks is not None else 500
    out = {"rank": rank, "shape": tuple(cc.shape)}
    out["ms"], out["plain_ms"] = in_turns(f"K1d [bgk+halo] {tag}", plain,
                                          k1d, 5, iters)
    _, out["k1a_ms"] = in_turns(f"K1a against K1d, same shard, {tag}", k1a,
                                k1d, iters, iters, names="K1a/K1d")
    out["device_ms"] = k1_device_ms(k1d)
    out["k1a_device_ms"] = k1_device_ms(k1a)
    out["bound_ms"] = bound_ms(step_bytes(cc, cc.fluid, cc.step_bcs)
                               + planes)
    windows = [bc for bc in cc.z_bcs if bc.window is not None]
    if windows:
        no_z = dataclasses.replace(cc, bcs=cc.kernel_bcs)

        def k1d_no_z():
            K.collide_stream(state[0], state[1], no_z, series, 0, 0,
                             halo=halo)
            state.reverse()

        out["no_z_device_ms"] = k1_device_ms(k1d_no_z)
        out["z_ms"] = out["device_ms"] - out["no_z_device_ms"]
        f_out = state[1].clone()
        out["z_plain_ms"] = time_ms(lambda: [K.fix_z_plane_plain(
            state[0], f_out, cc, bc, 0, halo=halo) for bc in windows], 5)
        out["z_bound_ms"] = out["bound_ms"] - bound_ms(
            step_bytes(cc, cc.fluid, cc.kernel_bcs) + planes)
        out["z_windows"] = len(windows)
        del f_out
    print(f"[3e] K1d {tag}: {out['ms']:.4f} ms a launch by CUDA events "
          f"(K1a on the same shard {out['k1a_ms']:.4f}, plain "
          f"{out['plain_ms']:.4f}); device time by the profiler "
          f"{out['device_ms']:.4f} (K1a {out['k1a_device_ms']:.4f}); bound "
          f"{out['bound_ms']:.6f} ms ({int(cc.fluid.sum())} fluid cells, "
          f"{planes} bytes of planes)"
          + (f"; its {out['z_windows']} z windows {out['z_ms']:.5f} ms of "
             f"device time in the launch (without them "
             f"{out['no_z_device_ms']:.4f}; plain fixups "
             f"{out['z_plain_ms']:.4f}, bound {out['z_bound_ms']:.7f})"
             if windows else ""), flush=True)
    del state, halo
    free_device()
    return out


def sharded_rank(mesh, case, opts, steps, time_save, out_dir):
    """One rank of phases 16 and 17: get_case(case, **opts) with the
    'velsum' residual on this rank of `mesh` (gloo ranks sharing the
    card, or NCCL ranks one card each),
    `steps` steps in chunks of time_save, counters reset just before and
    read just after; then 100 rounds of the exchange alone and the
    gathered f_standard(), which rank 0 writes to out_dir/f.npy. Returns
    this rank's numbers."""
    import dataclasses

    import numpy as np
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.parallel.halo import Exchange, edge_planes

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    spec = dataclasses.replace(get_case(case, **opts),
                               residual_flavor="velsum")
    sim = Simulation(spec, device=mesh.device.type, mesh=mesh)
    setup_s = time.perf_counter() - t0
    mesh.barrier()
    K.reset_launches()
    marks = []
    t_run = time.perf_counter()
    res = sim.run(max_steps=steps, time_save=time_save, verbose=False,
                  on_save=chunk_clock(marks))
    sync()
    counts = dict(K.launches)
    swap = Exchange(mesh)
    planes = edge_planes(sim.f, sim.shard_axis)
    mesh.barrier()
    sync()
    t1 = time.perf_counter()
    for _ in range(100):
        swap(*planes)
    sync()
    exchange_ms = (time.perf_counter() - t1) / 100 * 1e3
    t2 = time.perf_counter()
    f = sim.f_standard()
    sync()
    gather_s = time.perf_counter() - t2
    if mesh.rank == 0:
        np.save(os.path.join(out_dir, "f.npy"), f.cpu().numpy())
    cc = sim.cc
    return {"rank": mesh.rank, "counts": counts, "steps": res.steps,
            "converged": res.converged, "velsum": res.velsum_series,
            "ms": res.elapsed_s / res.steps * 1e3,
            "chunks": chunk_ms(t_run, marks, time_save),
            "exchange_ms": exchange_ms, "setup_s": setup_s,
            "gather_s": gather_s, "shape": tuple(cc.shape),
            "z_windows": sum(bc.window is not None for bc in cc.z_bcs),
            "live_blocks": (None if cc.live_blocks is None
                            else cc.live_blocks.numel()),
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if mesh.device.type == "cuda" else 0.0)}


def sharded_path(label, case, opts, world, steps, time_save, ref_f, ref_vs,
                 ref_steps, k1d, device_type="cuda", backend="gloo",
                 extra_calls=()):
    """Phase 16: Simulation(mesh=) of `case` on `world` gloo ranks that
    share the card (their planes staged through pinned host memory), or
    with backend 'nccl' (phase 17) on `world` cards, one rank each; the
    'velsum' residual on, against the unsharded run of the same steps
    (ref_f: its f_standard() as a NumPy file, ref_vs its velsum series,
    ref_steps its step count): f_standard() bit for bit off the DEAD
    cells and zeros on them, the velsum series within 1e-5 relative, the
    same stop step; every rank launched K1d (the launch counter k1d)
    once a step, its z windows in the same launch, and no z-plane fixup. device_type: the gloo
    ranks' ('cpu' rehearses the phase without a card). extra_calls:
    (fn, args) pairs each rank runs after the path in the same spawn
    (phase 20; parallel/launch.run_many), their results in rank order
    under "extra". Returns the numbers."""
    import numpy as np

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.parallel.launch import run_many, spawn

    tag = (f"[16] {label}, {world} gloo ranks on one card"
           if backend == "gloo" else
           f"[17] {label}, {world} {backend} ranks, one card each")
    where = ("in the one-card arrangement, not a scale-out figure"
             if backend == "gloo" else f"on {world} cards")
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        t0 = time.perf_counter()
        calls = [(sharded_rank, (case, opts, steps, time_save, tmp)),
                 *extra_calls]
        results = spawn(run_many, world, (calls,), backend=backend,
                        device=device_type, timeout=900)
        wall_s = time.perf_counter() - t0
        ranks = [r[0] for r in results]
        got = np.load(os.path.join(tmp, "f.npy"))
    want = np.load(ref_f)
    live = np.asarray(get_case(case, **opts).mask) != 0
    require(got.shape == want.shape, f"{tag}: f_standard shape {got.shape}")
    n_diff = int((got[:, live] != want[:, live]).sum())
    require(n_diff == 0 and not got[:, ~live].any(),
            f"{tag}: f_standard() differs from the unsharded run at {n_diff} "
            "values off the DEAD cells, or is not zero on them")
    del got, want
    vs = ranks[0]["velsum"]
    require(all(r["steps"] == ref_steps for r in ranks)
            and all(np.array_equal(r["velsum"], vs) for r in ranks),
            f"{tag}: the ranks' steps or velsum series differ")
    v_rel = float(np.max(np.abs(vs - ref_vs) / np.abs(ref_vs)))
    require(v_rel <= 1e-5, f"{tag}: velsum rel err {v_rel:.3e} > 1e-5")
    for r in ranks:
        c = r["counts"]
        require(c.get(k1d) == steps
                and not [k for k in c if "fix_z_plane" in k],
                f"{tag}: rank {r['rank']} launched {c} ({r['z_windows']} z "
                f"windows, {steps} steps)")
    out = {"ms": max(r["ms"] for r in ranks),
           "exchange_ms": max(r["exchange_ms"] for r in ranks),
           "launches": sum(r["counts"].get(k1d, 0) for r in ranks),
           "z_windows": sum(r["z_windows"] for r in ranks),
           "velsum_rel_err": v_rel, "wall_s": wall_s,
           "extra": [[r[j] for r in results]
                     for j in range(1, len(calls))]}
    print(f"{tag} ({ref_steps} steps, chunks of {time_save}), {where}: "
          "ms/step per rank "
          f"{[round(r['ms'], 4) for r in ranks]} (host clock, "
          f"synchronized; rank 0's chunks of {time_save}: "
          f"{ranks[0]['chunks']}, the first with the group's first "
          "exchange), the exchange alone "
          f"{[round(r['exchange_ms'], 4) for r in ranks]} ms a step; local "
          f"shapes {[r['shape'] for r in ranks]}, live blocks "
          f"{[r['live_blocks'] for r in ranks]}, z windows "
          f"{[r['z_windows'] for r in ranks]}; set-up "
          f"{max(r['setup_s'] for r in ranks):.1f} s, f_standard() gather "
          f"{max(r['gather_s'] for r in ranks):.1f} s, peak device memory "
          f"per rank {max(r['peak_gib'] for r in ranks):.2f} GiB, "
          f"{wall_s:.1f} s in all; f_standard() bit-equal to the unsharded "
          f"run off the DEAD cells, zeros on them; velsum max rel err "
          f"{v_rel:.3e}; stop step {ref_steps} on every rank; launches per "
          f"rank {[r['counts'] for r in ranks]}", flush=True)
    return out


def nccl_path(world, full, p20_dir=None):
    """Phase 17: the full coronary `full` (its spec) on y over `world`
    NCCL ranks, one card each, against an unsharded run of the same 200
    steps on card 0 (sharded_path's checks), in the same spawn phase
    20(a), the sharded K7 washout, against phase 20's unsharded run (its
    files in p20_dir; not run without them), then `run --shard world` on
    the 64^3 cavity, which must write VTK and CONVERGENCE.log."""
    import dataclasses

    import numpy as np

    from lbm_tpu_torch.engine.runner import Simulation

    sim = Simulation(dataclasses.replace(full, residual_flavor="velsum"),
                     device="cuda")
    res = sim.run(max_steps=200, time_save=100, verbose=False)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        ref = os.path.join(tmp, "coronary.npy")
        np.save(ref, sim.f_standard().cpu().numpy())
        ref_vs, ref_steps = res.velsum_series, res.steps
        del sim, res
        free_device()
        extra = ([] if p20_dir is None
                 else [(sharded_washout_rank, (p20_dir,))])
        # the vessel's shards launch over their fluid cells
        out = sharded_path("coronary full on y", "coronary", FULL_CORONARY,
                           world, 200, 100, ref, ref_vs, ref_steps,
                           "lbm_collide_stream_list[bgk+halo]",
                           backend="nccl", extra_calls=extra)
    if p20_dir is not None:
        check_sharded_washout(f"[17] sharded K7 washout, {world} nccl ranks, "
                              "one card each", out["extra"][0], world)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "lbm_tpu_torch", "run", "--shard",
             str(world), "--case", "lid_driven_cavity", "--opt", "n=64",
             "--steps", "500", "--time-save", "100", "--out", tmp],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        files = sorted(os.listdir(tmp))
        require(proc.returncode == 0 and "CONVERGENCE.log" in files
                and "lid_driven_cavity_500.vtk" in files,
                f"run --shard {world} over NCCL failed ({proc.returncode}), "
                f"wrote {files}:\n{proc.stdout}\n{proc.stderr}")
        print(f"[17] CLI run --shard {world} over NCCL in "
              f"{time.perf_counter() - t0:.1f} s wrote {files}; "
              f"{' | '.join(proc.stdout.strip().splitlines()[-2:])}",
              flush=True)


def _rank_sync(mesh):
    import torch

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _peak_gib(mesh) -> float:
    import torch

    if mesh.device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(mesh.device) / 2**30


def _reset_peak(mesh) -> None:
    import torch

    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)


def time_k7_block(tr, turns_k: int = 400, turns_p: int = 10) -> dict:
    """K7 a launch on this rank's halo-row block (the sharded route's
    ScalarShard and state), in turns block/same shape unsharded/plain/
    plain/same shape unsharded/block by CUDA events: the same shape as a
    box of its own (its mask rows, the block's frozen u and comp, every
    touched cell listed) through compile_scalar, and the plain version on
    the block. Bounds: scalar_bytes over each case's fluid cells. First
    one launch on the block into a copy of its state against the plain
    version on the same inputs: the largest difference, g and the record
    row ("max_abs_err")."""
    import types

    import torch

    from lbm_tpu_torch.engine.scalar import compile_scalar
    from lbm_tpu_torch.kernels import scalar_stream as S

    sc = tr.sc
    box = types.SimpleNamespace(name=tr.spec.name, shape=sc.shape,
                                mask=sc.mask.cpu().numpy(),
                                boundaries=tr.spec.boundaries)
    whole = compile_scalar(box, sc.device, tau_g=sc.tau_g,
                           inlet_c={0: 1.0})
    whole.u, whole.comp = sc.u, sc.comp
    state = [tr._g, tr._g_spare]
    other = [tr._g.clone(), tr._g.clone()]
    n_bc = len(sc.bcs)
    row = torch.zeros((1, n_bc), dtype=torch.float64, device=sc.device)
    out_k = state[0].clone()
    S.scalar_stream(state[0], out_k, sc, 0, series=row)
    g_p, rec_p = S.scalar_stream_plain(state[0], sc, 0)
    err = max(float((out_k - g_p).abs().max()),
              float((row[0] - rec_p).abs().max()) if n_bc else 0.0)
    del out_k, g_p

    def block():
        S.scalar_stream(state[0], state[1], sc, 0)
        state.reverse()

    def unsharded():
        S.scalar_stream(other[0], other[1], whole, 0)
        other.reverse()

    def plain():
        S.scalar_stream_plain(state[0], sc, 0)

    b1, u1, p1 = (time_ms(block, turns_k), time_ms(unsharded, turns_k),
                  time_ms(plain, turns_p))
    p2, u2, b2 = (time_ms(plain, turns_p), time_ms(unsharded, turns_k),
                  time_ms(block, turns_k))
    return {"max_abs_err": err,
            "ms": (b1 + b2) / 2, "unsharded_ms": (u1 + u2) / 2,
            "plain_ms": (p1 + p2) / 2, "turns": [b1, u1, p1, p2, u2, b2],
            "bound_ms": bound_ms(scalar_bytes(sc, False)),
            "unsharded_bound_ms": bound_ms(scalar_bytes(whole, False)),
            "shape": list(sc.shape), "listed_cells": int(sc.cells.numel()),
            "unsharded_listed_cells": (None if whole.cells is None
                                       else int(whole.cells.numel())),
            "fluid_cells": int(sc.fluid.sum())}


def sharded_washout_rank(mesh, tmp):
    """One rank of phase 20(a) (and of phase 17's): the steady full
    coronary's frozen-field transport, ScalarTransport(mesh=,
    backend='kernel') split along y (K7 on the rank's halo-row block), u
    from phase 9's flow (tmp/u.npy), D=0.02, a 50-step bolus at boundary
    0, every boundary recorded, PHASE20_STEPS steps, the scalar counters
    reset just before and read just after; then 100 rounds of the halo
    rows' exchange alone, and the gathered g and c, which rank 0 holds
    against the unsharded K7 run's (tmp/g.npy, tmp/series.npy). Then
    rank 1 (rank 0 alone in a world of one) times K7 on its block while
    the others wait (time_k7_block). Returns this rank's numbers."""
    import numpy as np
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.scalar import ScalarTransport
    from lbm_tpu_torch.kernels import scalar_stream as S
    from lbm_tpu_torch.parallel.launch import Gate

    t_start = time.perf_counter()
    spec = get_case("coronary", **STEADY_CORONARY)
    rec = list(range(len(spec.boundaries)))
    tr = ScalarTransport(spec, np.load(os.path.join(tmp, "u.npy")), D=0.02,
                         inlet_c={0: Gate(50)}, device=mesh.device.type,
                         mesh=mesh, shard_axis=1)
    _rank_sync(mesh)
    setup_s = time.perf_counter() - t_start
    _reset_peak(mesh)
    mesh.barrier()
    S.reset_launches()
    _rank_sync(mesh)
    t0 = time.perf_counter()
    series = tr.run(PHASE20_STEPS, record=rec)
    _rank_sync(mesh)
    ms = (time.perf_counter() - t0) / PHASE20_STEPS * 1e3
    counts = dict(S.launches)
    peak = _peak_gib(mesh)
    mesh.barrier()
    _rank_sync(mesh)
    t0 = time.perf_counter()
    for _ in range(100):
        tr._fill_halo_rows()
    _rank_sync(mesh)
    exchange_ms = (time.perf_counter() - t0) / 100 * 1e3
    g = tr.g.cpu().numpy()
    c = tr.concentration()
    fluid = tr.fluid
    out = {"rank": mesh.rank, "counts": counts, "ms": ms,
           "exchange_ms": exchange_ms, "setup_s": setup_s,
           "peak_gib": peak, "block": list(tr.sc.shape),
           "listed_cells": int(tr.sc.cells.numel()),
           "finite": bool(np.isfinite(g).all()),
           "c_lo": float(c[fluid].min()), "c_hi": float(c[fluid].max()),
           "total": tr.total(), "series_rows": series.shape[0]}
    del c, fluid
    if mesh.rank == 0:
        ref = np.load(os.path.join(tmp, "g.npy"), mmap_mode="r")
        out["g_diff"] = int(sum(int((g[i] != ref[i]).sum())
                                for i in range(g.shape[0])))
        ref_series = np.load(os.path.join(tmp, "series.npy"))
        out["series_ok"] = bool(np.allclose(series, ref_series, rtol=2e-6,
                                            atol=1e-8))
        out["series_max_abs_err"] = float(np.abs(series - ref_series).max())
        out["series_peaks"] = [float(v) for v in series.max(axis=0)]
    del g
    timer = 1 if mesh.world > 1 else 0
    mesh.barrier()
    if mesh.rank == timer and mesh.device.type == "cuda":
        out["timing"] = time_k7_block(tr)
    mesh.barrier()
    out["seconds"] = time.perf_counter() - t_start
    return out


def sharded_clinical_rank(mesh, tmp):
    """One rank of phase 20(b): the clinical coronary (phase 18's tree
    and RCR values) on the dense backend, Simulation(mesh=,
    backend='dense') split along y, PHASE20_WK_STEPS steps in chunks of
    half: lbm_tpu's GSPMD windkessel route. Its own rows of f against the
    unsharded dense run's (tmp/f_wk.npy) off the DEAD cells, at rtol
    3e-6 / atol 1e-7: the count of values outside and the largest
    difference; its P_c. Returns this rank's numbers."""
    import numpy as np

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.geometry.mask import CellType

    t_start = time.perf_counter()
    spec = get_case("coronary", **FULL_CORONARY, windkessel=CLINICAL_WK)
    sim = Simulation(spec, device=mesh.device.type, backend="dense",
                     mesh=mesh)
    _rank_sync(mesh)
    setup_s = time.perf_counter() - t_start
    _reset_peak(mesh)
    mesh.barrier()
    _rank_sync(mesh)
    t0 = time.perf_counter()
    res = sim.run(max_steps=PHASE20_WK_STEPS,
                  time_save=PHASE20_WK_STEPS // 2, verbose=False)
    _rank_sync(mesh)
    ms = (time.perf_counter() - t0) / res.steps * 1e3
    peak = _peak_gib(mesh)
    rows = sim.cc.shape[1]
    lo = mesh.rank * rows
    hi = min(lo + rows, spec.shape[1])
    ref = np.load(os.path.join(tmp, "f_wk.npy"), mmap_mode="r")
    live = np.asarray(spec.mask)[:, lo:hi] != CellType.DEAD
    viol, worst = 0, 0.0
    for i in range(19):
        got = sim.f[i, :, :hi - lo].cpu().numpy()[live]
        want = np.asarray(ref[i, :, lo:hi])[live]
        diff = np.abs(got - want)
        viol += int((diff > 1e-7 + 3e-6 * np.abs(want)).sum()
                    + (~np.isfinite(got)).sum())
        worst = max(worst, float(diff.max()) if diff.size else 0.0)
    return {"rank": mesh.rank, "wk": sim.wk.cpu().numpy(), "ms": ms,
            "steps": res.steps, "peak_gib": peak, "setup_s": setup_s,
            "violations": viol, "max_abs_err": worst, "rows": [lo, hi],
            "seconds": time.perf_counter() - t_start}


def p20_coupled_kw() -> dict:
    """Phase 20's small CoupledTransport options (unsharded and on the
    ranks)."""
    from lbm_tpu_torch.parallel.launch import Gate

    return dict(tau_g=0.6, inlet_c={0: Gate(50)}, backend="dense")


def sharded_dense_references(device, tmp) -> dict:
    """Phase 20's references that need no kernel, run while the kernels
    build: (b) the unsharded dense clinical run, its f written to tmp (P_c
    kept); (c) the small dense CoupledTransport and BuoyantTransport
    unsharded (kept). Returns the references."""
    import numpy as np
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.scalar import CoupledTransport
    from lbm_tpu_torch.engine.thermal import BuoyantTransport
    from lbm_tpu_torch.parallel.launch import transport_setup

    tag = "[20] references"
    t0 = time.perf_counter()
    clin = get_case("coronary", **FULL_CORONARY, windkessel=CLINICAL_WK)
    sim = Simulation(clin, device=device, backend="dense")
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = sim.run(max_steps=PHASE20_WK_STEPS,
                  time_save=PHASE20_WK_STEPS // 2, verbose=False)
    torch.cuda.synchronize()
    ref = {"wk": sim.wk.cpu().numpy(),
           "wk_ms": (time.perf_counter() - t1) / res.steps * 1e3,
           "wk_peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
    np.save(os.path.join(tmp, "f_wk.npy"), sim.f_standard().cpu().numpy())
    del sim
    free_device()
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = SMALL_TRANSPORTS
    cspec, _ = transport_setup(small["coupled"])
    ct = CoupledTransport(cspec, device=device, **p20_coupled_kw())
    ref["coupled"] = {"series": ct.run(PHASE20_WK_STEPS, record=list(
        range(len(cspec.boundaries)))), "f": ct.f.cpu().numpy(),
        "g": ct.g.cpu().numpy(), "wk": ct.wk.cpu().numpy()}
    del ct
    bspec, bkw = transport_setup(small["buoyant"])
    bt = BuoyantTransport(bspec, device=device, backend="dense", **bkw)
    ref["buoyant"] = {"energy": bt.run(PHASE20_RB_STEPS, record_energy=True),
                      "f": bt.f.cpu().numpy(), "g": bt.g.cpu().numpy()}
    del bt
    free_device()
    t_c = time.perf_counter() - t0
    ref["seconds"] = {"b": t_b, "c": t_c}
    print(f"{tag} (while the kernels build): the unsharded dense clinical "
          f"run ({PHASE20_WK_STEPS} steps at {ref['wk_ms']:.4f} ms/step, "
          f"peak {ref['wk_peak_gib']:.2f} GiB) and its file {t_b:.1f} s; "
          f"the small coupled and buoyant runs {t_c:.1f} s", flush=True)
    return ref


def sharded_transports_path(device, tmp, ref):
    """Phase 20's last reference (the unsharded runs the ranks are held
    to) and its calls for the spawn of phase 16b (sharded_path's
    extra_calls): (a) the unsharded K7 washout of tmp/u.npy, its g and
    series written to tmp; ref: sharded_dense_references' (b) and (c).
    Returns (calls, references)."""
    import numpy as np

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.scalar import ScalarTransport
    from lbm_tpu_torch.kernels import scalar_stream as S
    from lbm_tpu_torch.parallel.launch import (
        Gate,
        run_transport,
        transport_setup,
    )

    tag = "[20] references"
    t0 = time.perf_counter()
    spec = get_case("coronary", **STEADY_CORONARY)
    rec = list(range(len(spec.boundaries)))
    tr = ScalarTransport(spec, np.load(os.path.join(tmp, "u.npy")), D=0.02,
                         inlet_c={0: Gate(50)}, device=device)
    S.reset_launches()
    series = tr.run(PHASE20_STEPS, record=rec)
    require(S.launches.get("lbm_scalar_stream[frozen+comp]")
            == PHASE20_STEPS, f"{tag}: unsharded K7 launches {S.launches}")
    np.save(os.path.join(tmp, "g.npy"), tr.g.cpu().numpy())
    np.save(os.path.join(tmp, "series.npy"), series)
    del tr
    free_device()
    t_a = time.perf_counter() - t0
    ref = dict(ref, series=series, seconds=dict(ref["seconds"], a=t_a))
    print(f"{tag}: the unsharded K7 washout ({PHASE20_STEPS} steps) and its "
          f"files {t_a:.1f} s", flush=True)
    small = SMALL_TRANSPORTS
    cspec, _ = transport_setup(small["coupled"])
    calls = [(sharded_washout_rank, (tmp,)),
             (sharded_clinical_rank, (tmp,)),
             (run_transport, (small["coupled"], "coupled",
                              dict(p20_coupled_kw(), shard_axis=1),
                              PHASE20_WK_STEPS,
                              list(range(len(cspec.boundaries))))),
             (run_transport, (small["buoyant"], "buoyant",
                              dict(backend="dense", shard_axis=0),
                              PHASE20_RB_STEPS, None, None, True))]
    return calls, ref


def check_sharded_washout(tag, ranks, world) -> dict:
    """Phase 20(a)'s checks on the ranks' numbers (sharded_washout_rank):
    K7 [frozen+comp] PHASE20_STEPS times on every rank and nothing else,
    the gathered g bit for bit, the series within rtol 2e-6 / atol 1e-8,
    finite, -0.01 <= c <= 1.1. Returns the numbers for the kernels line."""
    r0 = ranks[0]
    name = "lbm_scalar_stream[frozen+comp]"
    for r in ranks:
        require(r["counts"] == {name: PHASE20_STEPS},
                f"{tag}: rank {r['rank']} launched {r['counts']}")
        require(r["finite"] and -0.01 <= r["c_lo"] and r["c_hi"] <= 1.1,
                f"{tag}: rank {r['rank']}: finite {r['finite']}, c "
                f"{r['c_lo']:.4g}..{r['c_hi']:.4g}")
    require(r0["g_diff"] == 0,
            f"{tag}: the gathered g differs from the unsharded K7 run's at "
            f"{r0['g_diff']} values")
    require(r0["series_ok"], f"{tag}: the records differ from the "
            f"unsharded run's by {r0['series_max_abs_err']:.3e}")
    timing = [r["timing"] for r in ranks if "timing" in r]
    require(len(timing) == 1 and timing[0]["max_abs_err"] == 0.0,
            f"{tag}: K7 on the block against its plain version: "
            f"{[t['max_abs_err'] for t in timing]}")
    out = {"ms": max(r["ms"] for r in ranks),
           "exchange_ms": max(r["exchange_ms"] for r in ranks),
           "launches_per_rank": [r["counts"][name] for r in ranks],
           "peak_gib": max(r["peak_gib"] for r in ranks),
           "series_max_abs_err": r0["series_max_abs_err"],
           "seconds": max(r["seconds"] for r in ranks),
           "timing": timing[0] if timing else None}
    t = out["timing"]
    print(f"{tag} steady coronary (291, 291, 372) r=12 on y, {world} ranks, "
          f"blocks {[r['block'] for r in ranks]} (the rank's rows and a halo "
          f"row each side), {[r['listed_cells'] for r in ranks]} listed "
          f"cells: {PHASE20_STEPS} steps at ms/step per rank "
          f"{[round(r['ms'], 4) for r in ranks]} (host clock, synchronized), "
          "the halo rows' exchange alone "
          f"{[round(r['exchange_ms'], 4) for r in ranks]} ms a step; set-up "
          f"{max(r['setup_s'] for r in ranks):.1f} s; peak device memory per "
          f"rank {out['peak_gib']:.2f} GiB; the gathered g bit-equal to the "
          f"unsharded K7 run; record max abs err "
          f"{out['series_max_abs_err']:.3e}; record peaks "
          f"{[round(v, 5) for v in r0['series_peaks']]}; c "
          f"{min(r['c_lo'] for r in ranks):.4g}..{max(r['c_hi'] for r in ranks):.4g}"
          f", total() {r0['total']:.6g}; launches per rank "
          f"{[r['counts'] for r in ranks]}; {out['seconds']:.1f} s on the "
          "ranks", flush=True)
    if t is not None:
        print(f"{tag} K7 [frozen+comp] a launch on rank 1's block "
              f"{t['shape']} ({t['listed_cells']} listed cells, "
              f"{t['fluid_cells']} fluid): {t['ms']:.5f} ms (bound "
              f"{t['bound_ms']:.5f}); the same shape unsharded "
              f"({t['unsharded_listed_cells']} listed) {t['unsharded_ms']:.5f}"
              f" ms (bound {t['unsharded_bound_ms']:.5f}); plain "
              f"{t['plain_ms']:.4f} ms (CUDA events, turns block/unsharded/"
              f"plain/plain/unsharded/block: "
              f"{[round(v, 5) for v in t['turns']]})", flush=True)
    return out


def check_sharded_transports(extra, ref, world) -> dict:
    """Phase 20's checks, (a) to (c), on the results of its calls in the
    spawn of phase 16b. Returns its numbers."""
    import numpy as np

    from lbm_tpu_torch.geometry.mask import CellType
    from lbm_tpu_torch.parallel.launch import transport_setup

    out = {"washout": check_sharded_washout(
        f"[20a] sharded K7 washout, {world} gloo ranks on one card",
        extra[0], world)}
    tag = f"[20b] clinical coronary on the dense backend, {world} gloo ranks"
    ranks = extra[1]
    wk = ranks[0]["wk"]
    require(all(np.array_equal(r["wk"].view(np.int32), wk.view(np.int32))
                for r in ranks), f"{tag}: the ranks' P_c differ: "
            f"{[r['wk'].tolist() for r in ranks]}")
    pc_err = float(np.abs(wk - ref["wk"]).max())
    require(pc_err <= 1e-6 * float(np.abs(ref["wk"]).max()),
            f"{tag}: P_c {wk.tolist()} against the unsharded "
            f"{ref['wk'].tolist()}")
    require(all(r["violations"] == 0 for r in ranks),
            f"{tag}: f outside rtol 3e-6 / atol 1e-7 of the unsharded run "
            f"at {[r['violations'] for r in ranks]} values (max abs err "
            f"{[r['max_abs_err'] for r in ranks]})")
    out["clinical"] = {"ms": max(r["ms"] for r in ranks),
                       "peak_gib": max(r["peak_gib"] for r in ranks),
                       "unsharded_ms": ref["wk_ms"],
                       "unsharded_peak_gib": ref["wk_peak_gib"],
                       "pc_max_abs_err": pc_err,
                       "f_max_abs_err": max(r["max_abs_err"] for r in ranks),
                       "seconds": max(r["seconds"] for r in ranks)}
    print(f"{tag}: {ranks[0]['steps']} steps at ms/step per rank "
          f"{[round(r['ms'], 4) for r in ranks]} (host clock, synchronized; "
          f"unsharded {ref['wk_ms']:.4f}); peak device memory per rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB (unsharded "
          f"{ref['wk_peak_gib']:.2f}); every rank's P_c bit-equal, "
          f"{wk.tolist()}, max abs err against the unsharded run "
          f"{pc_err:.3e}; f max abs err "
          f"{out['clinical']['f_max_abs_err']:.3e} off the DEAD cells; set-up "
          f"{max(r['setup_s'] for r in ranks):.1f} s, "
          f"{out['clinical']['seconds']:.1f} s on the ranks", flush=True)
    tag = f"[20c] small dense transports, {world} gloo ranks"
    cor, rb = extra[2], extra[3]
    want = ref["coupled"]
    cspec, _ = transport_setup(SMALL_TRANSPORTS["coupled"])
    live = np.asarray(cspec.mask) != CellType.DEAD
    require(all(np.array_equal(r["wk"].view(np.int32),
                               cor[0]["wk"].view(np.int32)) for r in cor),
            f"{tag}: the coupled ranks' P_c differ")
    checks = [
        ("coupled f", cor[0]["f"][:, live], want["f"][:, live], 3e-6, 1e-7),
        ("coupled g", cor[0]["g"], want["g"], 3e-6, 1e-7),
        ("coupled records", cor[0]["series"], want["series"], 2e-6, 1e-8)]
    for name, got, exp, rtol, atol in checks:
        require(np.allclose(got, exp, rtol=rtol, atol=atol),
                f"{tag}: {name} max abs err {np.abs(got - exp).max():.3e}")
    pc = float(np.abs(cor[0]["wk"] - want["wk"]).max())
    require(pc <= 1e-6 * float(np.abs(want["wk"]).max()),
            f"{tag}: coupled P_c {cor[0]['wk']} against {want['wk']}")
    want = ref["buoyant"]
    require(np.array_equal(rb[0]["f"], want["f"])
            and np.array_equal(rb[0]["g"], want["g"]),
            f"{tag}: the buoyant f or g differ from the unsharded run's")
    require(np.allclose(rb[0]["energy"], want["energy"], rtol=3e-6,
                        atol=1e-9),
            f"{tag}: energy max rel err "
            f"{np.abs(rb[0]['energy'] / want['energy'] - 1).max():.3e}")
    out["small"] = {"coupled_ms": max(r["ms"] for r in cor),
                    "buoyant_ms": max(r["ms"] for r in rb),
                    "coupled_pc_max_abs_err": pc}
    print(f"{tag}: CoupledTransport, the small clinical coronary (64, 48, "
          f"96) r=4 with its 4 RCR outlets, on y, {PHASE20_WK_STEPS} steps "
          f"at {out['small']['coupled_ms']:.4f} ms/step: f, g and the records"
          f" within tolerance of the unsharded run, every rank's P_c "
          f"bit-equal, {pc:.3e} from the unsharded; BuoyantTransport, "
          f"rayleigh_benard_3d 64x64x34 on x, {PHASE20_RB_STEPS} steps at "
          f"{out['small']['buoyant_ms']:.4f} ms/step: f and g bit-equal, "
          "the energy series within rtol 3e-6", flush=True)
    return out


def pipe_error(curved: bool, device) -> tuple:
    """(relative L2 error of u_z against Hagen-Poiseuille, ms/step) of the
    off-centre pipe n=36, nz=4, R=13.7 after 4000 dense steps, curved or
    staircase (the configuration of tests/test_bouzidi.py)."""
    import numpy as np

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.cases.pipe import pipe_sdf
    from lbm_tpu_torch.engine.runner import Simulation

    n, radius = 36, 13.7
    spec = get_case("pipe", n=n, nz=4, curved=curved, radius=radius)
    sim = Simulation(spec, device=device, backend="dense")
    res = sim.run(max_steps=4000, tol=-1.0, verbose=False)
    require(res.steps == 4000, f"pipe ran {res.steps} steps, not 4000")
    uz = sim.macro()[1][2][..., 2].cpu().numpy().astype(np.float64)
    c = ((n - 1) / 2 + 0.23, (n - 1) / 2 + 0.38)
    r = radius - pipe_sdf(n, radius, c)
    nu = (spec.tau - 0.5) / 3
    ua = spec.force[2] / (4 * nu) * (radius ** 2 - r ** 2)
    fl = np.asarray(spec.mask[..., 2]) == 4
    err = float(np.sqrt(np.sum((uz[fl] - ua[fl]) ** 2)
                        / np.sum(ua[fl] ** 2)))
    return err, res.elapsed_s / res.steps * 1e3


def total_line(stdout: str) -> str:
    return next((ln for ln in stdout.splitlines()
                 if "TOTAL RUNNING TIME" in ln), "no TOTAL RUNNING TIME line")


def curved_pipe_path(device) -> dict:
    """Phase 19c, which needs no kernel (side_checks runs it beside phase
    3's checks): the pipe's Hagen-Poiseuille error, curved and
    staircase, on 'dense' (its ms/step shares the card with those
    checks), and python -m lbm_tpu_torch run --case pipe on the kernel
    backend, in a process of its own, which must exit non-zero with
    lbm_tpu's refusal."""
    from lbm_tpu_torch.engine.compile import CURVED_REFUSAL

    tag = "[19]"
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        t0 = time.perf_counter()
        refusal = subprocess.Popen(
            [sys.executable, "-m", "lbm_tpu_torch", "run", "--case", "pipe",
             "--steps", "10", "--out", os.path.join(tmp, "k")], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            eb, ms_b = pipe_error(True, device)
            es, ms_s = pipe_error(False, device)
            _, err = refusal.communicate(timeout=600)
        finally:
            refusal.kill()
            refusal.wait()
    require(eb < 0.008 and eb < 0.35 * es,
            f"{tag} pipe error curved {eb:.4f}, staircase {es:.4f}: not "
            "under 0.008 and 0.35x the staircase's")
    print(f"{tag} pipe n=36 R=13.7, 4000 dense steps (beside phase 3's "
          "checks): "
          f"Hagen-Poiseuille error curved {eb:.5f} ({ms_b:.4f} "
          f"ms/step), staircase {es:.5f} ({ms_s:.4f} ms/step), ratio "
          f"{eb / es:.3f}", flush=True)
    require(refusal.returncode != 0 and CURVED_REFUSAL in err,
            f"CLI pipe on the kernel backend: exit {refusal.returncode}, "
            f"stderr {err[-400:]}")
    print(f"{tag} python -m lbm_tpu_torch run --case pipe (kernel backend) "
          f"exits {refusal.returncode}: {err.strip().splitlines()[-1]}",
          flush=True)
    free_device()
    mark("19c")
    return {"curved_err": eb, "staircase_err": es, "curved_ms": ms_b,
            "staircase_ms": ms_s, "refusal_exit": refusal.returncode,
            "wall_s": time.perf_counter() - t0}


# phase 8's `run --shard 1` and the files it must write
CLI_SHARD = ["run", "--case", "lid_driven_cavity", "--steps", "500",
             "--time-save", "100", "--shard", "1", "--opt", "n=64"]
CLI_SHARD_FILES = ["CONVERGENCE.log", "lid_driven_cavity_500.vtk"]


def cli_shard_start() -> tuple:
    """`python -m lbm_tpu_torch` CLI_SHARD --out <a .chip_smoke_ directory>
    started in a process of its own; returns what cli_shard_wait takes."""
    tmp = tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_")
    argv = [*CLI_SHARD, "--out", os.path.join(tmp.name, "out")]
    with open(os.path.join(tmp.name, "stdout"), "w") as out, \
            open(os.path.join(tmp.name, "stderr"), "w") as err:
        proc = child(subprocess.Popen(
            [sys.executable, "-m", "lbm_tpu_torch", *argv], cwd=ROOT,
            stdout=out, stderr=err, text=True))
    return proc, tmp, time.perf_counter()


def cli_shard_wait(started) -> None:
    """Phase 8's check of cli_shard_start's run: exit 0 and
    CLI_SHARD_FILES written; its directory is removed."""
    proc, tmp, t0 = started
    proc.wait(timeout=600)
    with tmp as d:
        with open(os.path.join(d, "stdout")) as out, \
                open(os.path.join(d, "stderr")) as err:
            stdout, stderr = out.read(), err.read()
        require(proc.returncode == 0,
                f"CLI {' '.join(CLI_SHARD)} failed ({proc.returncode}):\n"
                f"{stdout}\n{stderr}")
        files = sorted(os.listdir(os.path.join(d, "out")))
        require(all(w in files for w in CLI_SHARD_FILES),
                f"CLI outputs of {' '.join(CLI_SHARD)} missing: {files}")
    last = stdout.strip().splitlines()[-2:]
    print(f"[8] CLI {' '.join(CLI_SHARD[1:])} (a process of its own, "
          f"started with the build) ran in {time.perf_counter() - t0:.1f} s "
          f"wrote {files}; {' | '.join(last)}", flush=True)


def halo_comparisons(full, device) -> dict:
    """Phase 3e's checks: K1d and its halo z fixup on 4 shards held in one
    process, every branch (halo_cases) for 20 steps, then the lid 256^3
    on x and the full coronary on y on 2 and 4 shards for 2 steps, each
    against its plain version and the whole-box step: {case: max abs
    err}."""
    from lbm_tpu_torch.cases import get_case

    halo_err = {}
    for label, name, kw, axis, exact in halo_cases():
        halo_err[f"{label}, 4 shards"] = compare_halo(
            label, get_case(name, **kw), axis, 4, 20, device, exact)
    lid256 = get_case("lid_driven_cavity", n=256)
    for world in (2, 4):
        halo_err[f"lid 256^3 on x, {world} shards"] = compare_halo(
            "lid 256^3 on x", lid256, 0, world, 2, device, True)
        halo_err[f"coronary full on y, {world} shards"] = compare_halo(
            "coronary full on y", full, 1, world, 2, device, True)
    return halo_err


def side_checks(device, u_path: str) -> dict:
    """What runs in a process of its own (side_checks_start) beside phase
    3's other checks, which share nothing with it: the scalar and thermal
    kernels against their plain versions (scalar_comparisons; the steady
    full coronary's velocity field, which scalar_timings reuses, saved
    to u_path), K1d against its plain version (halo_comparisons), then
    phase 19c (curved_pipe_path). It times no kernel; main times none
    until it has ended."""
    import numpy as np
    import torch

    from lbm_tpu_torch.cases import get_case

    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_case("coronary", **FULL_CORONARY)
    scalar_err, path_err, u_full = scalar_comparisons(full, device)
    np.save(u_path, u_full.cpu().numpy())
    del u_full
    free_device()
    mark("3 (K7, K8, K1e checks)")
    halo_err = halo_comparisons(full, device)
    del full
    free_device()
    mark("3e (K1d checks)")
    return {"scalar_err": scalar_err, "path_err": path_err,
            "halo_err": halo_err, "pipe": curved_pipe_path(device)}


def side_checks_start(u_path: str) -> tuple:
    """side_checks in a process of its own on the card, its output kept
    for side_checks_wait."""
    code = ("import json, sys, torch\n"
            "import chip_smoke as C\n"
            "print(json.dumps(C.side_checks(torch.device('cuda', 0), "
            "sys.argv[1]), default=float))\n")
    log = tempfile.TemporaryFile("w+", dir=ROOT, prefix=".chip_smoke_")
    return child(subprocess.Popen(
        [sys.executable, "-c", code, u_path], cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT, text=True)), log, time.perf_counter()


def side_checks_wait(started) -> dict:
    """side_checks' results from side_checks_start's process, its lines
    printed first (its phase clock its own)."""
    proc, log, t_start = started
    t0 = time.perf_counter()
    proc.wait(timeout=1200)
    log.seek(0)
    lines = log.read().strip().splitlines()
    log.close()
    print(f"[3] the scalar and K1d checks and phase 19c ran in a process of "
          f"their own, started {t0 - t_start:.1f} s before phase 3's other "
          f"checks ended (waited {time.perf_counter() - t0:.1f} s more); "
          "its lines:", flush=True)
    for line in lines[:-1]:
        print(line.replace("[t] phase", "[t, the side process] phase"),
              flush=True)
    require(proc.returncode == 0, f"the side process of phase 3's checks "
            f"failed ({proc.returncode}): {lines[-1] if lines else ''}")
    return json.loads(lines[-1])


def mem_start(device) -> int:
    """Free the cached blocks, reset the peak: the bytes still held."""
    import torch

    free_device()
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def peak_gib(device, base) -> float:
    """The peak device memory since mem_start above its `base`, GiB."""
    import torch

    return (torch.cuda.max_memory_allocated(device) - base) / 2**30


def velsum_rel(a, b) -> float:
    """The largest relative difference of two velsum series."""
    return float(abs(a - b).max() / abs(b).min())


def curved_sparse_dense(device) -> dict:
    """Phase 19a, which needs no kernel and runs while the kernels build
    (its ms/step share the host with nvcc): the full curved coronary
    (Bouzidi walls) on 'sparse' (CURVED_STEPS steps) against 'dense'
    (200), f at the fluid cells at rtol 3e-6 / atol 1e-7 and the velsum
    series at 1e-5 relative after 200 steps; ms/step, peak device memory
    and a 20-step profile of the sparse step."""
    import dataclasses

    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.sparse import gather_live

    tag = "[19]"
    out = {}
    u_in = 0.1745 / 2.74909090909091

    t0 = time.perf_counter()
    cspec = dataclasses.replace(
        get_case("coronary", **FULL_CORONARY, curved=True),
        residual_flavor="velsum")
    spec_s = time.perf_counter() - t0
    base = mem_start(device)
    t0 = time.perf_counter()
    sp = Simulation(cspec, device=device, backend="sparse")
    sc = sp.sc
    compile_sp = time.perf_counter() - t0
    marks = []
    t0 = time.perf_counter()
    rs = sp.run(max_steps=200, time_save=100, tol=-1.0, verbose=False,
                on_save=chunk_clock(marks))
    require(rs.steps == 200, f"{tag} sparse ran {rs.steps} steps")
    f_sp = sp.f[:, sc.fluid].clone()
    sp_peak = peak_gib(device, base)
    n_links = 0 if sc.links is None else int(sc.links[0].numel())
    print(f"{tag} curved coronary {tuple(cspec.shape)} (while the kernels "
          f"build): spec {spec_s:.1f} s; "
          f"sparse: {sc.n_live} live cells ({int(sc.fluid.sum())} fluid, "
          f"{n_links} Bouzidi links), compile {compile_sp:.1f} s, 200 steps "
          f"{rs.elapsed_s / 200 * 1e3:.4f} ms/step (chunks of 100: "
          f"{chunk_ms(t0, marks, 100)}), peak device memory {sp_peak:.2f} "
          "GiB above what was held", flush=True)
    base = mem_start(device)
    t0 = time.perf_counter()
    de = Simulation(cspec, device=device, backend="dense")
    de.cc.bouzidi  # the links, built at first use
    compile_de = time.perf_counter() - t0
    marks = []
    t0 = time.perf_counter()
    rd = de.run(max_steps=200, time_save=100, tol=-1.0, verbose=False,
                on_save=chunk_clock(marks))
    de_peak = peak_gib(device, base)
    f_de = gather_live(sc, de.f)[:, sc.fluid]
    err = check_close(f"{tag} curved coronary sparse vs dense, 200 steps",
                      f_sp, f_de, 3e-6, 1e-7)
    vrel = velsum_rel(rs.velsum_series, rd.velsum_series)
    require(vrel <= 1e-5, f"{tag} curved coronary velsum sparse vs dense "
            f"{vrel:.3e} > 1e-5")
    out["curved"] = {
        "live_cells": sc.n_live, "fluid_cells": int(sc.fluid.sum()),
        "links": n_links, "sparse_ms": rs.elapsed_s / 200 * 1e3,
        "dense_ms": rd.elapsed_s / 200 * 1e3, "sparse_peak_gib": sp_peak,
        "dense_peak_gib": de_peak, "max_abs_err": err,
        "bit_equal": bool(torch.equal(f_sp, f_de)), "velsum_rel": vrel,
        "compile_s": {"sparse": compile_sp, "dense": compile_de}}
    print(f"{tag} curved coronary dense: compile {compile_de:.1f} s, 200 "
          f"steps {out['curved']['dense_ms']:.4f} ms/step (chunks of 100: "
          f"{chunk_ms(t0, marks, 100)}), peak device memory {de_peak:.2f} "
          f"GiB above what was held; f at fluid cells sparse vs dense max "
          f"abs err {err:.3e} (bit-equal {out['curved']['bit_equal']}), "
          f"velsum max rel diff {vrel:.3e}", flush=True)
    del de, f_de, f_sp
    free_device()
    marks = []
    t0 = time.perf_counter()
    rs2 = sp.run(max_steps=CURVED_STEPS - 200, time_save=600, tol=-1.0,
                 verbose=False, on_save=chunk_clock(marks))
    by_name, busy = profile_run(sp, 20)
    rho, u = sp.macro()
    u_max = float(u.abs().max())
    require(bool(torch.isfinite(u).all()) and bool(torch.isfinite(rho).all())
            and u_max <= 3 * u_in,
            f"{tag} curved coronary sparse fields: max|u| {u_max:.4g}")
    out["curved"].update(sparse_ms_run=(rs.elapsed_s + rs2.elapsed_s)
                         / CURVED_STEPS * 1e3, sparse_busy=busy,
                         sparse_launches_per_step=sum(
                             v[1] for v in by_name.values()),
                         sparse_device_ms=sum(v[0] for v in by_name.values()))
    print(f"{tag} curved coronary sparse, steps 200-{CURVED_STEPS}: "
          f"{rs2.elapsed_s / (CURVED_STEPS - 200) * 1e3:.4f} ms/step "
          f"(chunks of 600: {chunk_ms(t0, marks, 600)}); {CURVED_STEPS} "
          f"steps at {out['curved']['sparse_ms_run']:.4f} ms/step; max|u| "
          f"{u_max:.4g} (inlet {u_in:.4g})", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    print(f"{tag} curved coronary sparse, a 20-step profile: device "
          f"{out['curved']['sparse_device_ms']:.4f} ms a step in "
          f"{out['curved']['sparse_launches_per_step']:.1f} launches, busy "
          f"{busy:.3f} of the traced window; "
          + "; ".join(f"{short_name(k)} {v[0]:.4f} x{v[1]:.1f}"
                      for k, v in top), flush=True)
    del sp, rho, u, sc
    free_device()
    mark("19a")
    return out["curved"]


def curved_path(device, full) -> dict:
    """Phase 19: Bouzidi curved walls and the live-cell (sparse) backend.
    The straight full coronary on 'sparse' against the kernel backend (K1
    [bgk] over the fluid list, counters reset just before and read just
    after) for 200 steps; the kernel backend's wss()
    on the full coronary through the live-cell route against its dense
    pull, and both routes on the default coronary, below lbm_tpu's line
    (first call and a later one); run --case pipe on 'dense' and 'sparse'
    and the curved coronary with --snapshots and --profile through the
    CLI (curved_pipe_path has the pipe's error and the refusal, and
    curved_sparse_dense the curved coronary)."""
    import dataclasses

    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.sparse import gather_live, scatter_dense
    from lbm_tpu_torch.engine.stress import wss_field, wss_sparse
    from lbm_tpu_torch.kernels import collide_stream as K

    tag = "[19]"
    out = {}

    # (b) the straight full coronary, sparse against the kernel backend
    vfull = dataclasses.replace(full, residual_flavor="velsum")
    kern = Simulation(vfull, device=device)
    K.reset_launches()
    marks = []
    t0 = time.perf_counter()
    rk = kern.run(max_steps=200, time_save=100, tol=-1.0, verbose=False,
                  on_save=chunk_clock(marks))
    torch.cuda.synchronize()
    counts = dict(K.launches)
    require(counts.get("lbm_collide_stream_list[bgk]") == 200,
            f"{tag} kernel backend launches: {counts}")
    k_chunks = chunk_ms(t0, marks, 100)
    base = mem_start(device)
    t0 = time.perf_counter()
    spr = Simulation(vfull, device=device, backend="sparse")
    compile_sp = time.perf_counter() - t0
    marks = []
    t0 = time.perf_counter()
    rs = spr.run(max_steps=200, time_save=100, tol=-1.0, verbose=False,
                 on_save=chunk_clock(marks))
    sp_peak = peak_gib(device, base)
    sc = spr.sc
    err = check_close(f"{tag} straight coronary sparse vs kernel, 200 steps",
                      spr.f[:, sc.fluid], gather_live(sc, kern.f)[:, sc.fluid],
                      3e-6, 1e-7)
    vrel = velsum_rel(rs.velsum_series, rk.velsum_series)
    require(vrel <= 1e-5, f"{tag} straight coronary velsum sparse vs "
            f"kernel {vrel:.3e} > 1e-5")
    out["straight"] = {
        "live_cells": sc.n_live, "sparse_ms": rs.elapsed_s / 200 * 1e3,
        "kernel_ms": rk.elapsed_s / 200 * 1e3, "max_abs_err": err,
        "velsum_rel": vrel, "sparse_peak_gib": sp_peak,
        "kernel_launches": counts["lbm_collide_stream_list[bgk]"]}
    print(f"{tag} straight coronary: sparse ({sc.n_live} live cells, compile "
          f"{compile_sp:.1f} s) {out['straight']['sparse_ms']:.4f} ms/step "
          f"(chunks {chunk_ms(t0, marks, 100)}), peak {sp_peak:.2f} GiB; "
          f"kernel backend {out['straight']['kernel_ms']:.4f} ms/step "
          f"(chunks {k_chunks}), launches {counts}; f at fluid cells max "
          f"abs err {err:.3e}, velsum max rel diff {vrel:.3e}", flush=True)
    del spr, sc
    mark("19b")

    # (d) the kernel backend's wss() through the live-cell route
    require(kern._wss_via_sparse(), f"{tag} the full coronary's wss() does "
            "not take the live-cell route")
    base = mem_start(device)
    t0 = time.perf_counter()
    w = kern.wss()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    first_rise = peak_gib(device, base)
    base = mem_start(device)
    t0 = time.perf_counter()
    w = kern.wss()
    torch.cuda.synchronize()
    wss_ms = (time.perf_counter() - t0) * 1e3
    rise = peak_gib(device, base)
    base = mem_start(device)
    t0 = time.perf_counter()
    cc, f32 = kern._dense_cc_f()
    w_dense = wss_field(cc, f32, kern.t, kern._normals(cc), wk=kern.wk)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    dense_rise = peak_gib(device, base)
    require(float(w.max()) > 0, f"{tag} WSS is zero")
    wss_err = check_close(f"{tag} live-cell WSS vs the dense pull", w,
                          w_dense, 1e-5, 1e-12)
    out["wss"] = {"ms_first": first_ms, "ms": wss_ms, "rise_gib": rise,
                  "rise_first_gib": first_rise, "dense_ms": dense_ms,
                  "dense_rise_gib": dense_rise, "max_abs_diff": wss_err,
                  "bit_equal": bool(torch.equal(w, w_dense)),
                  "max_pa": float(w.max()) * full.units.C_pre}
    print(f"{tag} kernel backend wss() on the full coronary, live-cell "
          f"route: {first_ms:.1f} ms first (the live-cell tables and "
          f"normals built; rise {first_rise:.2f} GiB), {wss_ms:.1f} ms "
          f"again, device memory rise {rise:.2f} GiB; the dense pull here "
          f"{dense_ms:.1f} ms, rise "
          f"{dense_rise:.2f} GiB; max abs diff {wss_err:.3e} (bit-equal "
          f"{out['wss']['bit_equal']}), max WSS {out['wss']['max_pa']:.4g} "
          "Pa", flush=True)
    del kern, w, w_dense, cc, f32
    free_device()

    # the two routes below lbm_tpu's line: the default coronary on the
    # kernel backend, each route's first call and a later one
    small = Simulation(get_case("coronary"), device=device)
    require(not small._wss_via_sparse(), f"{tag} the default coronary's "
            "wss() takes the live-cell route")
    small.run(max_steps=200, time_save=100, tol=-1.0, verbose=False)

    def live():
        sc, f_s = small._sparse_cc_f()
        return scatter_dense(sc, wss_sparse(
            sc, f_s, small.t, small._normals_sparse(sc), wk=small.wk))

    below = {}
    for route, fn in (("dense", small.wss), ("live", live)):
        for call in ("first", "again"):
            base = mem_start(device)
            t0 = time.perf_counter()
            below[route] = fn()
            torch.cuda.synchronize()
            out["wss"][f"below_{route}_{call}_ms"] = \
                (time.perf_counter() - t0) * 1e3
            out["wss"][f"below_{route}_{call}_rise_gib"] = peak_gib(device, base)
    out["wss"]["below_max_abs_diff"] = check_close(
        f"{tag} default coronary live-cell WSS vs the dense pull",
        below["live"], below["dense"], 1e-5, 1e-12)
    ws = out["wss"]
    print(f"{tag} kernel backend wss() on the default coronary "
          f"{tuple(small.spec.shape)}, below the line: " + "; ".join(
              f"{r} route {ws[f'below_{r}_first_ms']:.1f} ms first (rise "
              f"{ws[f'below_{r}_first_rise_gib']:.3f} GiB), "
              f"{ws[f'below_{r}_again_ms']:.1f} ms again (rise "
              f"{ws[f'below_{r}_again_rise_gib']:.3f} GiB)"
              for r in ("dense", "live"))
          + f"; max abs diff {ws['below_max_abs_diff']:.3e}", flush=True)
    del small, below
    free_device()
    mark("19d")

    # (e) the CLI, in this process
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        for backend in ("dense", "sparse"):
            d = os.path.join(tmp, "pipe_" + backend)
            t0 = time.perf_counter()
            proc = cli_run(["run", "--case", "pipe", "--backend", backend,
                            "--steps", "200", "--time-save", "100", "--out",
                            d])
            require(proc.returncode == 0 and os.path.exists(
                os.path.join(d, "pipe_200.vtk")),
                f"CLI pipe --backend {backend} failed ({proc.returncode}):"
                f"\n{proc.stdout}\n{proc.stderr}")
            print(f"{tag} CLI run --case pipe --backend {backend} in "
                  f"{time.perf_counter() - t0:.1f} s: "
                  f"{total_line(proc.stdout)}", flush=True)
        prof = os.path.join(tmp, "prof")
        cdir = os.path.join(tmp, "cor")
        t0 = time.perf_counter()
        proc = cli_run(["run", "--case", "coronary", "--backend", "sparse",
                        "--snapshots", "--profile", prof, "--no-vtk",
                        "--steps", "10", "--time-save", "5", "--out", cdir,
                        "--opt", "curved=true"])
        s = time.perf_counter() - t0
        files = sorted(os.listdir(cdir)) if os.path.isdir(cdir) else []
        trace_mb = (os.path.getsize(os.path.join(prof, "trace.json")) / 1e6
                    if os.path.exists(os.path.join(prof, "trace.json"))
                    else 0.0)
        require(proc.returncode == 0 and all(
            f in files for f in ("meas1.txt", "s1_out.txt", "vel.csv"))
            and trace_mb > 0.001,
            f"CLI coronary curved --backend sparse --snapshots --profile "
            f"failed ({proc.returncode}; files {files}, trace {trace_mb} "
            f"MB):\n{proc.stdout}\n{proc.stderr}")
        with open(os.path.join(prof, "trace.json")) as fh:
            head = fh.read(1 << 20)
        require('"traceEvents"' in head, "the profile holds no trace events")
        sizes = {f: os.path.getsize(os.path.join(cdir, f)) for f in files}
        print(f"{tag} CLI run --case coronary --opt curved=true --backend "
              f"sparse --snapshots --profile in {s:.1f} s: {sizes}, trace "
              f"{trace_mb:.1f} MB; {total_line(proc.stdout)}", flush=True)
    mark("19e")
    return out


# -- phase 21: the adjoint, Shan-Chen, binary and IBM modules (no kernel:
# lbm_tpu steps them through its XLA dense step, the port through its
# dense torch step), all but 21a's kernel verification while the kernels
# build ----------------------------------------------------------------------
ADJ_CASE = dict(shape=(96, 96, 120), radius=7,
                windkessel=[(1e-4, 5e3, 2e-3)] * 4)
ADJ_TARGET = (0.40, 0.27, 0.20, 0.13)   # tools/demo_adjoint.py's defaults
ADJ_STEPS = 600
ADJ_CHUNKS = (30, 20, 15, 10)           # each divides ADJ_STEPS
ADJ_PEAK_GIB = 60.0
ADJ_VERIFY_STEPS = 2000
P21_BOX = 256                           # phase 21d's full-width boxes
P21D_STEPS = 200


def p21_box(shape, tau=1.0, force=None):
    """A fully periodic all-FLUID box of the port's CaseSpec (lbm_tpu's
    tests' _free_box / _box)."""
    import numpy as np

    from lbm_tpu_torch.core.units import UnitSystem
    from lbm_tpu_torch.engine.spec import CaseSpec
    from lbm_tpu_torch.geometry.mask import CellType

    return CaseSpec(name="box", shape=tuple(shape), tau=tau,
                    units=UnitSystem(CH=1.0, C_U=1.0, C_rho=1.0),
                    mask=np.full(shape, int(CellType.FLUID), np.int32),
                    boundaries=[], force=force)


def adjoint_during_build(device) -> dict:
    """Phase 21a without its kernel run: at demo_adjoint's default width
    (coronary 96x96x120 r=7, four RCR outlets, a 600-step rollout) one
    value and gradient of the split loss with s/iteration and peak device
    memory (past 60 GiB, the largest remat chunk of 20/15/10 under it);
    d loss / d log Rd_0 against central differences (h = 0.1, rtol 2e-2);
    three fit_windkessel iterations, whose last loss is below the
    first."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine import adjoint
    from lbm_tpu_torch.engine.compile import compile_case

    spec = get_case("coronary", **ADJ_CASE)
    cc = compile_case(spec, device)
    target = torch.tensor(ADJ_TARGET, dtype=torch.float32, device=device)
    base = torch.from_numpy(adjoint.wk_params(cc)).to(device)

    def loss_at(log_rd, chunk, graphs):
        theta = torch.cat([base[:, :2], torch.exp(log_rd)[:, None]], dim=1)
        f, _ = adjoint.rollout(cc, theta, ADJ_STEPS, remat_chunk=chunk,
                               graphs=graphs)
        return torch.sum((adjoint.flow_split(cc, f) - target) ** 2)

    x0 = torch.log(base[:, 2])
    tried = []
    for chunk in ADJ_CHUNKS:
        graphs = adjoint.RolloutGraphs(cc) if device.type == "cuda" else None
        mem0 = mem_start(device)
        t0 = time.perf_counter()
        x = x0.clone().requires_grad_(True)
        loss = loss_at(x, chunk, graphs)
        (grad,) = torch.autograd.grad(loss, x)
        torch.cuda.synchronize()
        s_iter = time.perf_counter() - t0
        peak = peak_gib(device, mem0)
        tried.append((chunk, s_iter, peak))
        print(f"[21a] value and gradient of the split loss, coronary "
              f"{ADJ_CASE['shape']} r={ADJ_CASE['radius']}, {ADJ_STEPS}-step "
              f"rollout, remat_chunk {chunk}: {s_iter:.2f} s/iteration "
              f"(forward + backward), peak device memory {peak:.2f} GiB, "
              f"loss {float(loss.detach()):.6e}, grad "
              f"{[float(v) for v in grad]}", flush=True)
        if peak <= ADJ_PEAK_GIB:
            break
        print(f"[21a] peak {peak:.2f} GiB passes {ADJ_PEAK_GIB} GiB: the "
              "next smaller chunk", flush=True)
    require(peak <= ADJ_PEAK_GIB, f"21a: peak {peak:.2f} GiB at every chunk "
            f"{tried}")
    free_device()
    with torch.no_grad():
        t0 = time.perf_counter()
        h = torch.zeros_like(x0)
        h[0] = 0.1
        fd = (float(loss_at(x0 + h, chunk, graphs))
              - float(loss_at(x0 - h, chunk, graphs))) / 0.2
        torch.cuda.synchronize()
        s_fwd = (time.perf_counter() - t0) / 2
    auto = float(grad[0])
    rel = abs(auto - fd) / max(abs(fd), 1e-30)
    print(f"[21a] d loss / d log Rd_0: autograd {auto:.6e}, central "
          f"differences (h = 0.1) {fd:.6e}, rel {rel:.3e} (rtol 2e-2); a "
          f"forward rollout {s_fwd:.2f} s", flush=True)
    require(auto != 0.0 and rel <= 2e-2,
            f"21a: the adjoint gradient {auto} against FD {fd} (rel {rel})")
    del graphs
    free_device()
    t0 = time.perf_counter()
    theta, hist = adjoint.fit_windkessel(
        spec, ADJ_TARGET, n_steps=ADJ_STEPS, iters=3, lr=0.3,
        remat_chunk=chunk, verbose=True, device=device)
    torch.cuda.synchronize()
    s_fit = time.perf_counter() - t0
    losses = [h_[0] for h_ in hist]
    print(f"[21a] fit_windkessel: 3 iterations in {s_fit:.1f} s "
          f"({s_fit / 3:.2f} s/iteration), losses {losses}, fitted Rd "
          f"{[float(v) for v in theta[:, 2]]}", flush=True)
    require(losses[-1] < losses[0],
            f"21a: the fit's loss did not fall: {losses}")
    free_device()
    mark("21a (the adjoint)")
    return {"s_per_iter": s_iter, "peak_gib": peak, "remat_chunk": chunk,
            "tried": tried, "grad": auto, "fd": fd, "fd_rel": rel,
            "s_forward": s_fwd, "fit_s_per_iter": s_fit / 3,
            "losses": losses, "theta": theta}


def adjoint_verify(device, theta) -> dict:
    """Phase 21a's kernel run: the fitted terminations through Simulation
    on the kernel route (the windkessel fold), ADJ_VERIFY_STEPS steps; the
    fields finite; the split printed."""
    import numpy as np
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.diagnostics import plane_flux
    from lbm_tpu_torch.engine.runner import Simulation

    spec = get_case("coronary", **dict(
        ADJ_CASE, windkessel=[tuple(map(float, row)) for row in theta]))
    sim = Simulation(spec, device=device)
    t0 = time.perf_counter()
    sim.run(max_steps=ADJ_VERIFY_STEPS, time_save=500, verbose=False)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    rho, u = (a.cpu().numpy() for a in sim.macro())
    require(sim.backend == "kernel" and np.isfinite(rho).all()
            and np.isfinite(u).all() and bool(torch.isfinite(sim.f).all())
            and bool(torch.isfinite(sim.wk).all()),
            "21a: the fitted terminations' kernel run is not finite")
    idx = [k for k, b in enumerate(spec.boundaries)
           if b.windkessel is not None]
    q = np.asarray([plane_flux(spec, u, k) for k in idx])
    split = q / q.sum()
    print(f"[21a] fitted terminations through Simulation (backend "
          f"{sim.backend}: the windkessel fold), {sim.t} steps in {s:.2f} s: "
          f"finite; split {' '.join(f'{v:.4f}' for v in split)} (target "
          f"{ADJ_TARGET}, after 3 iterations), P_c "
          f"{sim.wk.cpu().numpy()}", flush=True)
    free_device()
    return {"verify_s": s, "split": split.tolist()}


def diffusivity_during_build(device) -> dict:
    """Phase 21b: transport_rollout on a frozen poiseuille 64^3 field (300
    dense flow steps) from a banded initial contrast, d mean((series -
    obs)^2) / d log(tau_g - 1/2) through a 40-step rollout against central
    differences (eps 1e-2, rtol 2e-2)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine import adjoint
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.scalar import ScalarTransport

    spec = get_case("poiseuille", n=64)
    sim = Simulation(spec, device=device, backend="dense")
    sim.run(max_steps=300, time_save=100, verbose=False)
    u = sim.macro()[1]
    # contrast filling the vessel in x-periodic bands: its outlet record
    # moves with D from the first step (a front from the inlet would take
    # hundreds of steps to reach the far plane of a 64^3 box)
    x = np.arange(64, dtype=np.float32)[:, None, None]
    c0 = np.broadcast_to(1.0 + 0.5 * np.cos(2.0 * np.pi * x / 16.0),
                         (64, 64, 64)).astype(np.float32)
    st = ScalarTransport(spec, u, D=0.03, inlet_c={0: 1.0}, c0=c0,
                         device=device, backend="dense")
    obs = adjoint.transport_rollout(st, 0.5 + 4 * 0.05, 40, [1],
                                    remat_chunk=20)

    def loss(x):
        s = adjoint.transport_rollout(st, 0.5 + torch.exp(x), 40, [1],
                                      remat_chunk=20)
        return torch.mean((s - obs) ** 2)

    x0 = torch.log(torch.tensor(4 * 0.03, dtype=torch.float32,
                                device=device))
    t0 = time.perf_counter()
    x = x0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x), x)
    torch.cuda.synchronize()
    s_grad = time.perf_counter() - t0
    with torch.no_grad():
        fd = (float(loss(x0 + 1e-2)) - float(loss(x0 - 1e-2))) / 2e-2
    g = float(g)
    rel = abs(g - fd) / max(abs(fd), 1e-30)
    print(f"[21b] diffusivity gradient, poiseuille 64^3 frozen field, "
          f"40-step transport rollout: autograd {g:.6e}, central "
          f"differences {fd:.6e}, rel {rel:.3e} (rtol 2e-2); value and "
          f"gradient {s_grad:.2f} s", flush=True)
    require(g != 0.0 and rel <= 2e-2,
            f"21b: the diffusivity gradient {g} against FD {fd}")
    free_device()
    mark("21b (the diffusivity gradient)")
    return {"grad": g, "fd": fd, "fd_rel": rel, "s_grad": s_grad}


def physics_anchors(device) -> dict:
    """Phase 21c: lbm_tpu's slow physics anchors on the card, each with its
    test's shapes, steps and assertions: the 3D Laplace law
    (tests/test_multiphase.py::test_laplace_law_3d), the Gibbs-Thomson
    droplet (tests/test_binary.py::test_gibbs_thomson_droplet_matches_
    analytic_sigma), Stokes' second problem (tests/test_ibm.py::
    test_ibm_stokes_second_problem_envelope); first the CUDA-graph
    replay against the eager step, bit for bit."""
    import numpy as np
    import torch

    from lbm_tpu_torch.engine.binary import (
        BinaryFluid,
        chemical_potential,
        interface_width,
        surface_tension,
    )
    from lbm_tpu_torch.engine.ibm import IBMFlow, marker_plane
    from lbm_tpu_torch.engine.multiphase import ShanChen, eos_pressure

    out = {}
    # the graph replay is the eager step
    n = 40
    rng = np.random.default_rng(0)
    rho0 = (np.log(2.0) * (1.0 + 0.01 * rng.standard_normal((n, n, n)))
            ).astype(np.float32)
    runs = {}
    for graph in (False, True):
        sc = ShanChen(p21_box((n, n, n)), G=-5.0, rho_init=rho0,
                      device=device, graph=graph)
        sc.run(20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.run(200)
        torch.cuda.synchronize()
        runs[graph] = (sc, (time.perf_counter() - t0) / 200 * 1e3)
    require(torch.equal(runs[True][0].f, runs[False][0].f),
            "21c: the CUDA-graph ShanChen step differs from the eager one")
    bf = [BinaryFluid(p21_box((n, n, n), tau=0.8), A=0.002, kappa=0.008,
                      phi_init=np.tanh(rho0 - np.log(2.0)) * 50.0,
                      device=device, graph=graph) for graph in (False, True)]
    for b in bf:
        b.run(50)
    require(torch.equal(bf[0].f, bf[1].f) and torch.equal(bf[0].g, bf[1].g),
            "21c: the CUDA-graph BinaryFluid step differs from the eager one")
    out["sc_ms_eager"], out["sc_ms_graph"] = runs[False][1], runs[True][1]
    print(f"[21c] ShanChen 40^3 ms/step: eager {runs[False][1]:.4f}, CUDA "
          f"graph {runs[True][1]:.4f} (bit for bit the same state; "
          f"BinaryFluid too)", flush=True)

    # the Laplace law
    t0 = time.perf_counter()
    dps, inv_r = [], []
    for R in (6, 8, 10):
        x, y, z = np.meshgrid(*(np.arange(n) - n / 2,) * 3, indexing="ij")
        r = np.sqrt(x * x + y * y + z * z)
        sc = ShanChen(p21_box((n, n, n)), G=-5.0,
                      rho_init=np.where(r < R, 1.8, 0.16).astype(np.float32),
                      device=device)
        sc.run(3000)
        rho = sc.rho().cpu().numpy()
        require(np.isfinite(rho).all(), f"21c: Laplace R={R} not finite")
        c = n // 2

        def p_of(v):
            return float(eos_pressure(torch.tensor(v, dtype=torch.float32),
                                      -5.0))

        p_in = p_of(rho[c - 2:c + 2, c - 2:c + 2, c - 2:c + 2].mean())
        p_out = p_of(np.concatenate([rho[:3].ravel(),
                                     rho[-3:].ravel()]).mean())
        dps.append(p_in - p_out)
        inv_r.append(1.0 / R)
    dps, inv_r = np.asarray(dps), np.asarray(inv_r)
    slope, icpt = np.polyfit(inv_r, dps, 1)
    resid = float(np.abs(np.polyval((slope, icpt), inv_r) - dps).max()
                  / dps.max())
    s_lap = time.perf_counter() - t0
    print(f"[21c] Laplace law, 40^3, R 6/8/10, 3 x 3000 steps in "
          f"{s_lap:.1f} s ({s_lap / 9000 * 1e3:.4f} ms/step): dp "
          f"{dps.tolist()}, sigma {slope / 2:.6e}, fit residual {resid:.4f} "
          "(dp > 0, sigma > 0, residual < 0.1)", flush=True)
    require((dps > 0).all() and slope / 2 > 0 and resid < 0.1,
            f"21c: the Laplace law: dp {dps}, slope {slope}, resid {resid}")
    out.update(laplace_dp=dps.tolist(), laplace_sigma=slope / 2,
               laplace_resid=resid, laplace_s=s_lap)

    # Gibbs-Thomson
    t0 = time.perf_counter()
    A, K = 0.002, 0.008
    sig, xi = surface_tension(A, K), interface_width(A, K)
    R = 8
    x, y, z = np.meshgrid(*(np.arange(n) - n / 2,) * 3, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    bf = BinaryFluid(p21_box((n, n, n), tau=0.8), A=A, kappa=K,
                     phi_init=np.tanh((R - r) / xi).astype(np.float32),
                     device=device)
    bf.run(8000)
    phi = bf.phi()
    require(bool(torch.isfinite(phi).all()), "21c: Gibbs-Thomson not finite")
    mu = chemical_potential(phi, A, K).cpu().numpy()
    c = n // 2
    dmu = float(mu[c - 2:c + 2, c - 2:c + 2, c - 2:c + 2].mean()
                - np.concatenate([mu[:3].ravel(), mu[-3:].ravel()]).mean())
    s_gt = time.perf_counter() - t0
    rel = abs(dmu - sig / R) / (sig / R)
    print(f"[21c] Gibbs-Thomson droplet, 40^3 R=8, 8000 steps in "
          f"{s_gt:.1f} s ({s_gt / 8000 * 1e3:.4f} ms/step): mu_in - mu_out "
          f"{dmu:.6e} against sigma/R {sig / R:.6e}, rel {rel:.4f} "
          "(rtol 0.15)", flush=True)
    require(rel <= 0.15, f"21c: Gibbs-Thomson {dmu} against {sig / R}")
    out.update(gibbs_dmu=dmu, gibbs_rel=rel, gibbs_s=s_gt)

    # Stokes' second problem
    t0 = time.perf_counter()
    shape = (4, 4, 48)
    tau, period, U0, zp = 0.8, 500, 0.02, 24.0
    nu = (tau - 0.5) / 3.0
    omega = 2.0 * np.pi / period
    k = np.sqrt(omega / (2.0 * nu))
    plate = marker_plane(zp, 2, shape)

    def U_of_t(t):
        u = np.zeros_like(plate)
        u[:, 0] = np.float32(U0) * np.cos(np.float32(omega) * np.float32(t))
        return u

    flow = IBMFlow(p21_box(shape, tau=tau), plate,
                   motion=(lambda t: plate, U_of_t), device=device)
    flow.run(2 * period)
    samples = []
    for _ in range(10):
        flow.run(period // 10)
        samples.append(flow.macro()[1][0][2, 2, :].cpu().numpy())
    amp = (np.max(samples, axis=0) - np.min(samples, axis=0)) / 2.0
    dz = np.arange(shape[2], dtype=np.float64) - zp
    sel = (dz >= 2.0) & (dz <= 8.0)
    slope, icpt = np.polyfit(dz[sel], np.log(amp[sel]), 1)
    shift = (icpt - np.log(U0)) / k
    s_st = time.perf_counter() - t0
    print(f"[21c] Stokes' second problem, 4x4x48, 1500 steps in {s_st:.1f} s"
          f" ({s_st / 1500 * 1e3:.4f} ms/step): decay {-slope:.6f} against "
          f"k {k:.6f} (rtol 0.05), origin shift {shift:.4f} (< 1.2 cells)",
          flush=True)
    require(abs(-slope - k) <= 0.05 * k and abs(shift) < 1.2,
            f"21c: Stokes decay {-slope} against {k}, shift {shift}")
    out.update(stokes_decay=-slope, stokes_k=k, stokes_shift=shift,
               stokes_s=s_st)
    free_device()
    mark("21c (lbm_tpu's slow physics anchors)")
    return out


def full_width_multiphase(device) -> dict:
    """Phase 21d: ShanChen (G = -5), BinaryFluid and IBMFlow (two
    marker_plane plates in a body-forced periodic channel) at 256^3 for
    200 steps each: fields finite, total mass (Sigma phi for the binary
    liquid) within 1e-5 relative in float64 sums, ms/step and peak device
    memory. IBM runs twice, with two forcing sweeps and with one, and one
    more step from each final state with its own sweeps: the two-sweep
    no-slip defect below 0.6 of the one-sweep one (tests/test_ibm.py's
    multi-direct-forcing contract, whose flows develop apart; from one
    state the ratio is the sweep's fixed 0.625)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.engine import ibm
    from lbm_tpu_torch.engine.binary import BinaryFluid, interface_width
    from lbm_tpu_torch.engine.multiphase import ShanChen

    n = P21_BOX
    shape = (n, n, n)
    rng = np.random.default_rng(21)
    out = {}

    def timed(obj, total):
        m0 = total()
        mem0 = mem_start(device)
        t0 = time.perf_counter()
        obj.run(P21D_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / P21D_STEPS * 1e3
        peak = peak_gib(device, mem0)
        m1 = total()
        return ms, peak, m0, m1, abs(m1 - m0) / abs(m0)

    rho0 = (np.log(2.0) * (1.0 + 0.01 * rng.standard_normal(shape))
            ).astype(np.float32)
    sc = ShanChen(p21_box(shape), G=-5.0, rho_init=rho0, device=device)
    del rho0
    ms, peak, m0, m1, rel = timed(sc, sc.total_mass)
    ok = bool(torch.isfinite(sc.f).all())
    print(f"[21d] ShanChen G=-5 {n}^3, {P21D_STEPS} steps: {ms:.4f} "
          f"ms/step (CUDA graph), peak {peak:.2f} GiB, finite {ok}, mass "
          f"{m0:.10e} -> {m1:.10e} (rel {rel:.3e})", flush=True)
    require(ok and rel <= 1e-5, f"21d: ShanChen finite {ok}, mass rel {rel}")
    out["shan_chen"] = {"ms": ms, "peak_gib": peak, "mass_rel": rel}
    del sc
    free_device()

    x, y, z = np.meshgrid(*(np.arange(n, dtype=np.float32) - n / 2,) * 3,
                          indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    del x, y, z
    A, K = 0.002, 0.008
    phi0 = np.tanh((80.0 - r) / interface_width(A, K)).astype(np.float32)
    del r
    bf = BinaryFluid(p21_box(shape, tau=0.8), A=A, kappa=K, phi_init=phi0,
                     device=device)
    del phi0
    ms, peak, m0, m1, rel = timed(bf, bf.total_phi)
    ok = bool(torch.isfinite(bf.f).all()) and bool(torch.isfinite(bf.g).all())
    print(f"[21d] BinaryFluid {n}^3 (a droplet of radius 80), "
          f"{P21D_STEPS} steps: {ms:.4f} ms/step (CUDA graph), peak "
          f"{peak:.2f} GiB, finite {ok}, Sigma phi {m0:.10e} -> {m1:.10e} "
          f"(rel {rel:.3e})", flush=True)
    require(ok and rel <= 1e-5, f"21d: BinaryFluid finite {ok}, phi rel {rel}")
    out["binary"] = {"ms": ms, "peak_gib": peak, "phi_rel": rel}
    del bf
    free_device()

    spec = p21_box(shape, tau=1.0, force=(1e-5, 0.0, 0.0))
    plates = np.concatenate([ibm.marker_plane(32.0, 2, shape),
                             ibm.marker_plane(224.0, 2, shape)])
    Xm = torch.from_numpy(plates).to(device)
    flat, w = ibm._support(Xm, shape)
    defects, runs = [], []
    for n_iter in (2, 1):
        flow = ibm.IBMFlow(spec, plates, n_iter=n_iter, device=device)

        def mass():
            return float(flow.f.sum(dtype=torch.float64))

        ms, peak, m0, m1, rel = timed(flow, mass)
        ok = bool(torch.isfinite(flow.f).all())
        step = ibm.make_ibm_step(flow.cc, n_iter=n_iter)
        u = step(flow.f, flow.t, Xm, torch.zeros_like(Xm))[2]
        defects.insert(0, float(ibm.interp(u, flat, w).abs().max()))
        runs.append((ms, peak, ok, rel))
        print(f"[21d] IBMFlow {n}^3, two plates ({len(plates)} markers), "
              f"gravity 1e-5, n_iter {n_iter}, {P21D_STEPS} steps: "
              f"{ms:.4f} ms/step, peak {peak:.2f} GiB, finite {ok}, mass "
              f"rel {rel:.3e}; one more step's no-slip defect "
              f"{defects[0]:.6e}", flush=True)
        del flow, u
        free_device()
    ms, peak, ok, rel = runs[0]
    print(f"[21d] IBM no-slip defect: one sweep {defects[0]:.6e}, two "
          f"{defects[1]:.6e} (ratio {defects[1] / defects[0]:.4f} < 0.6; "
          "each flow developed with its own sweeps, as lbm_tpu's test)",
          flush=True)
    require(all(r[2] and r[3] <= 1e-5 for r in runs)
            and defects[1] < 0.6 * defects[0],
            f"21d: IBM runs (ms, peak, finite, mass rel) {runs}, defects "
            f"{defects}")
    out["ibm"] = {"ms": ms, "peak_gib": peak, "mass_rel": rel,
                  "defects": defects, "ms_one_sweep": runs[1][0]}
    mark("21d (multiphase and IBM at 256^3)")
    return out


def phase21_during_build(device) -> dict:
    """Phase 21's kernel-free parts (21b, 21c, 21d, 21a's fit), run while
    the kernels build."""
    return {"21b": diffusivity_during_build(device),
            "21c": physics_anchors(device),
            "21d": full_width_multiphase(device),
            "21a": adjoint_during_build(device)}


# -- phase 22: the geometry pipeline and the bifurcation case -------------
# The reference's bif.stl, geo.txt and bc.txt are not in the repository,
# so phase 22 (and the port's tests, which import these helpers) runs the
# case and the L0->L7 loop on synthetic inputs made from a seed: a Y
# bifurcation in the case's 64 x 83 x 32 box, a surface reconstructed from
# points sampled on it, and an inlet profile in bc.txt's layout.
BIF_SHAPE = (64, 83, 32)
BIF_SEED = 22
BIF_POINTS = 4000
BIF_INLET_PEAK = 0.05        # lattice units, the parabola's peak at y = 1
BIF_STEPS = 4400             # the reference's fixed run (l0l7's default)
# the grid reconstruct_surface rasterizes the cloud on: 3/4 of the box's
# own, so that each slice's ring of samples closes after one dilation at
# the fork too, where the union's surface is sparsest in y (on the box's
# own grid the fork's slices stay hollow, and the lumen is cut there)
BIF_SURFACE_GRID = (48, 64, 24)
BIF_CHECK_STEPS = SMALL_STEPS


def bif_capsules() -> list:
    """The synthetic Y bifurcation's tubes as (start, end, radius) in cell
    coordinates: the parent along y from y = 0 to 40 (radius 9, centred at
    x = 32, z = 16), and two daughters leaving its end at +-25 degrees in
    the x-y plane (radius 6.5) up to y = 82."""
    import numpy as np

    fork = (32.0, 40.0, 16.0)
    reach = 42.0 * np.tan(np.radians(25.0))
    return [((32.0, 0.0, 16.0), fork, 9.0)] + [
        (fork, (32.0 + s * reach, 82.0, 16.0), 6.5) for s in (-1, 1)]


def _segment_distance(p, a, b):
    """Distance of the points p (..., 3) from the segment a-b."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    d = b - a
    t = np.clip(((p - a) @ d) / (d @ d), 0.0, 1.0)
    return np.linalg.norm(p - (a + t[..., None] * d), axis=-1)


def bif_occupancy():
    """The union of the capsules at the cell centres (integer coordinates)
    with the box's outer ring cleared, as stl_to_occupancy leaves it:
    (64, 83, 32) int32, the synthetic "shipped" geo.txt."""
    import numpy as np

    grid = np.stack(np.meshgrid(*[np.arange(n, dtype=np.float64)
                                  for n in BIF_SHAPE], indexing="ij"), -1)
    occ = np.zeros(BIF_SHAPE, bool)
    for a, b, r in bif_capsules():
        occ |= _segment_distance(grid, a, b) <= r
    occ[[0, -1]] = occ[:, [0, -1]] = occ[:, :, [0, -1]] = False
    return occ.astype(np.int32)


def bif_cloud(seed: int = BIF_SEED, n: int = BIF_POINTS):
    """n points on the bifurcation's surface: each capsule's wall and its
    two hemispherical ends where no other capsule holds them, within 0 <=
    y <= 82 (the tubes stay open at the box's ends), jittered by 1e-3:
    (n, 3)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    caps = bif_capsules()
    pts = []
    for i, (a, b, r) in enumerate(caps):
        a, b = np.asarray(a), np.asarray(b)
        length = np.linalg.norm(b - a)
        axis = (b - a) / length
        e1 = np.cross(axis, [0.0, 0.0, 1.0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(axis, e1)
        m = int(2.0 * n * r * length / 1000.0)
        t, th = rng.uniform(0, 1, m), rng.uniform(0, 2 * np.pi, m)
        side = (a + t[:, None] * (b - a) + r * (np.cos(th)[:, None] * e1
                                                + np.sin(th)[:, None] * e2))
        ends = []
        for end, out in ((a, -axis), (b, axis)):
            d = rng.standard_normal((int(2.0 * n * r * r / 1000.0), 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            ends.append(end + r * d[d @ out > 0])
        p = np.concatenate([side] + ends)
        keep = (p[:, 1] >= 0) & (p[:, 1] <= 82)
        for j, (a2, b2, r2) in enumerate(caps):
            if j != i:
                keep &= _segment_distance(p, a2, b2) > r2
        pts.append(p[keep])
    pts = np.concatenate(pts)
    pts = pts[rng.choice(len(pts), n, replace=False)]
    return pts + 1e-3 * rng.standard_normal(pts.shape)


def bif_open(mask) -> bool:
    """Whether a bifurcation mask's inlet cells reach its outlet cells
    through its fluid cells (6-connected)."""
    import numpy as np
    import scipy.ndimage as ndi

    mask = np.asarray(mask)
    lab, _ = ndi.label(np.isin(mask, (2, 3, 4)))
    return bool((set(np.unique(lab[mask == 2]))
                 & set(np.unique(lab[mask == 3]))) - {0})


def write_binary_stl(path: str, verts, faces) -> None:
    """A binary STL of the triangles verts[faces] (float32, their normals
    from the corners' order)."""
    import numpy as np

    tri = np.asarray(verts, np.float64)[np.asarray(faces)]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    rec = np.zeros(len(tri), np.dtype([("v", "<f4", (12,)), ("a", "<u2")]))
    rec["v"] = np.concatenate([n, tri.reshape(-1, 9)], axis=1)
    with open(path, "wb") as fh:
        fh.write(b"synthetic bifurcation".ljust(80, b" "))
        fh.write(np.uint32(len(tri)).tobytes())
        fh.write(rec.tobytes())


def bif_bc_slabs():
    """bc.txt's two (nx, nz) slabs: slab 0 all zeros (the shipped file's
    quirk), slab 1 a parabola of peak BIF_INLET_PEAK over the parent
    tube's cross-section at y = 1."""
    import numpy as np

    nx, _, nz = BIF_SHAPE
    (cx, _, cz), _, r = bif_capsules()[0]
    x, z = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
    r2 = ((x - cx) ** 2 + (z - cz) ** 2) / r ** 2
    return np.stack([np.zeros((nx, nz)),
                     np.where(r2 < 1, BIF_INLET_PEAK * (1 - r2), 0.0)])


def bifurcation_inputs(out_dir: str, seed: int = BIF_SEED,
                       surface: bool = True) -> dict:
    """Write the synthetic geo.txt (bif_occupancy, save_geo's xyz order),
    bc.txt (bif_bc_slabs in load_bc's layout) and, with `surface`, bif.stl
    (reconstruct_surface of bif_cloud on BIF_SURFACE_GRID, a binary STL
    in cell units: l0l7 voxelizes it back at spacing 1) into out_dir:
    {"geo", "bc", "stl": paths, "surface_s": seconds of the surface}."""
    import numpy as np

    from lbm_tpu_torch.geometry.io import save_geo
    from lbm_tpu_torch.geometry.reconstruct import reconstruct_surface

    paths = {k: os.path.join(out_dir, n) for k, n in (
        ("geo", "geo.txt"), ("bc", "bc.txt"), ("stl", "bif.stl"))}
    save_geo(paths["geo"], bif_occupancy(), order="xyz")
    with open(paths["bc"], "w") as fh:
        fh.write(" ".join(f"{v:.9g}" for s in bif_bc_slabs()
                          for v in s.T.ravel()))
    paths["surface_s"] = 0.0
    if surface:
        t0 = time.perf_counter()
        verts, faces = reconstruct_surface(bif_cloud(seed),
                                           BIF_SURFACE_GRID)
        write_binary_stl(paths["stl"], verts, faces)
        paths["surface_s"] = time.perf_counter() - t0
        paths["stl_triangles"] = int(len(faces))
    return paths


def bifurcation_path(device) -> dict:
    """Phase 22: (a) the port's lbm_geo build (g++) and its seconds, the
    synthetic inputs, smooth_mesh (both modes) and voxelize_mesh on the
    native library against their NumPy plain versions; (b) the bifurcation
    case on the kernel route (the list K1: a y-plane field inlet with rho
    extrapolated, a y-plane rho* = 1 outlet with u extrapolated) against
    step_plain for BIF_CHECK_STEPS steps, then K3, counters reset just
    before and read just after; (c) the L0->L7 chain through
    tools/l0l7_bifurcation.l0l7, BIF_STEPS steps on each geometry, its
    counters reset just before and read just after; (d) `run --case
    bifurcation --snapshots` through the CLI in this process."""
    import numpy as np
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.cases.bifurcation import build_labels
    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.geometry import native, preprocess, reconstruct
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.tools.l0l7_bifurcation import l0l7

    out, seconds = {}, {}
    t0 = time.perf_counter()
    lib = native.load()
    out["gxx"] = {"built": lib.built, "build_s": lib.build_seconds,
                  "cmd": " ".join((native.compiler(),) + native.CXX_FLAGS)}
    print(f"[22a] lbm_geo {'built' if lib.built else 'found'} at "
          f"{os.path.relpath(lib.path, ROOT)} in {lib.build_seconds:.2f} s "
          f"({out['gxx']['cmd']})", flush=True)
    tmp = tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_")
    files = bifurcation_inputs(tmp.name)
    out["surface_s"] = files["surface_s"]
    # the blocky mesh reconstruct_surface smooths, and the surface's voxels
    occ, origin, spacing = reconstruct.cloud_to_occupancy(
        bif_cloud(), BIF_SURFACE_GRID)
    verts, faces = reconstruct.voxel_boundary_mesh(occ, origin, spacing)
    smooth = {}
    for mode, iters in (("inversedistance", 8), ("curvature", 1)):
        a = native.smooth_mesh(verts, faces, iters, mode)
        b = native.smooth_mesh(verts, faces, iters, mode, native=False)
        smooth[mode] = float(np.abs(a - b).max())
        require(smooth[mode] <= 1e-9, f"smooth_mesh {mode}: native and "
                f"NumPy differ by {smooth[mode]:.3e} > 1e-9")
    tris = native.load_stl(files["stl"])
    vox = native.voxelize_mesh(tris, BIF_SHAPE, spacing=1.0)
    vox_np = native.voxelize_mesh(tris, BIF_SHAPE, spacing=1.0, native=False)
    n_diff = int((vox != vox_np).sum())
    require(n_diff <= 1e-3 * vox.size, f"voxelize_mesh: {n_diff} of "
            f"{vox.size} cells differ between native and NumPy")
    self_flag = preprocess.extrude_open_ends(
        preprocess.stl_to_occupancy(files["stl"], BIF_SHAPE, spacing=1.0),
        axis=1)
    require(bif_open(build_labels(self_flag)), "the surface voxelized back "
            "at spacing 1 leaves no fluid path from inlet to outlet")
    out.update(smooth_max_abs_err=smooth, voxels_differing=n_diff,
               voxels=int(vox.sum()), triangles=files["stl_triangles"])
    seconds["a"] = time.perf_counter() - t0
    print(f"[22a] synthetic inputs: a Y bifurcation {BIF_SHAPE}, occupancy "
          f"{bif_occupancy().mean():.4f}; its surface from {BIF_POINTS} "
          f"points (seed {BIF_SEED}) by reconstruct_surface in "
          f"{files['surface_s']:.2f} s, {files['stl_triangles']} "
          f"triangles; native vs NumPy: smoothing max abs err "
          f"{smooth}, voxels at spacing 1 differing {n_diff} of "
          f"{vox.size} ({int(vox.sum())} occupied); {seconds['a']:.1f} s",
          flush=True)

    # (b) the case on the kernel route against step_plain, then K3
    t1 = time.perf_counter()
    spec = get_case("bifurcation", geo_path=files["geo"], bc_path=files["bc"])
    errs = {"K1a": 0.0, "Kz": 0.0, "K3": 0.0}
    K.reset_launches()
    e = compare_case(("bifurcation", {}), BIF_CHECK_STEPS, device, errs,
                     spec=spec, label=f"bifurcation {BIF_SHAPE} synthetic")
    check_counts = dict(K.launches)
    cc = compile_case(spec, device)
    route = K.counter_name(cc)
    require(route == "lbm_collide_stream_list[bgk]"
            and check_counts.get(route, 0) >= BIF_CHECK_STEPS
            and check_counts.get("lbm_macro", 0) >= 1,
            f"bifurcation check launches {check_counts} (want {route} "
            f"{BIF_CHECK_STEPS}+ and lbm_macro)")
    out.update(check_max_abs_err=e, check_launches=check_counts,
               fluid_cells=int(cc.fluid_cells.numel()))
    del cc
    seconds["b"] = time.perf_counter() - t1
    print(f"[22b] bifurcation: {route} over {out['fluid_cells']} fluid "
          f"cells, launches {check_counts}; {seconds['b']:.1f} s",
          flush=True)

    # (c) the L0->L7 chain, the slice's main path
    t2 = time.perf_counter()
    free_device()
    K.reset_launches()
    chain = l0l7(files["stl"], files["geo"], files["bc"], steps=BIF_STEPS,
                 spacing=1.0, device=device, backend="kernel",
                 log=lambda s: print(f"[22c] {s}", flush=True))
    torch.cuda.synchronize()
    counts = dict(K.launches)
    require(counts.get(route, 0) == 2 * BIF_STEPS
            and counts.get("lbm_macro", 0) >= 2,
            f"L0->L7 launches {counts} (want {route} {2 * BIF_STEPS} and "
            "lbm_macro at least twice)")
    for tag in ("shipped-geo", "self-voxelized"):
        run = chain[tag]
        require(run["finite"] and run["u_max"] <= 3 * run["inlet_peak"]
                and run["steps"] == BIF_STEPS,
                f"L0->L7 {tag}: {run} (want {BIF_STEPS} steps, finite, "
                "max|u| within 3x the inlet peak)")
    # the two geometries' developed flows agree where both are fluid (a
    # CPU run of the same chain: l2_rel 0.174, corr 0.979): a surface
    # that cut the lumen, or a run that lost the inlet, shows here
    stats = chain["compare_midplane"]
    require(stats["corr"] >= 0.9, f"L0->L7 midplanes: {stats} (want the "
            "correlation of the two runs' midplanes at least 0.9)")
    out.update(path=chain, launches=counts)
    seconds["c"] = time.perf_counter() - t2
    print(f"[22c] L0->L7 chain: launches {counts}; {seconds['c']:.1f} s",
          flush=True)

    # (d) the CLI
    t3 = time.perf_counter()
    cdir = os.path.join(tmp.name, "cli")
    proc = cli_run(["run", "--case", "bifurcation", "--opt",
                    f"geo_path={files['geo']}", f"bc_path={files['bc']}",
                    "--steps", "400", "--time-save", "200", "--snapshots",
                    "--out", cdir])
    require(proc.returncode == 0, f"CLI run --case bifurcation failed "
            f"({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    names = sorted(os.listdir(cdir))
    require({"meas1.txt", "s1_out.txt", "vel.csv", "CONVERGENCE.log"}
            <= set(names) and any(n.endswith(".vtk") for n in names),
            f"CLI run --case bifurcation wrote {names}")
    seconds["d"] = time.perf_counter() - t3
    print(f"[22d] CLI run --case bifurcation --snapshots wrote {names}; "
          f"{total_line(proc.stdout)}; {seconds['d']:.1f} s", flush=True)
    tmp.cleanup()
    out["seconds"] = seconds
    mark("22")
    return out


# -- phase 23: the 512^3 demos and the profile tools ------------------------
P23_N = 512
P23_STEPS = 20            # demo_512_outputs' chunk (its default)
P23_RESUME = 5            # its --resume-steps
P23_RANKS = 8             # demo_512_sharded's --ndev
P23_SHARD_STEPS = 2       # its --steps
P23_FLOW = 2000           # demo_512_washout's --flow-steps
P23_WASHOUT = 3000        # its --steps
P23_BOLUS = 800           # its --bolus
P23_CHUNK = 500           # its --chunk
P23_DISK_BYTES = 16e9     # the VTK (~2.6 GB) and the checkpoint (10.2 GB)
P23_HOST_GB = 24.0        # the checkpoint's read and its load (10.2 GB each)


def p23_workdir():
    """Phase 23's files go to the faster of the checkout and the system's
    temporary directory that has P23_DISK_BYTES free: each gets a
    .chip_smoke_ directory and a 256 MB write with fsync. Returns (the
    chosen TemporaryDirectory, {base: (free GB, write GB/s)})."""
    rates, dirs = {}, {}
    block = os.urandom(1 << 20) * 256
    for base in dict.fromkeys((ROOT, tempfile.gettempdir())):
        tmp = tempfile.TemporaryDirectory(dir=base, prefix=".chip_smoke_")
        path = os.path.join(tmp.name, "rate")
        t0 = time.perf_counter()
        with open(path, "wb") as fh:
            fh.write(block)
            fh.flush()
            os.fsync(fh.fileno())
        rate = len(block) / (time.perf_counter() - t0) / 1e9
        os.remove(path)
        rates[base] = (shutil.disk_usage(tmp.name).free / 1e9, rate)
        dirs[base] = tmp
    ok = [b for b in rates if rates[b][0] * 1e9 >= P23_DISK_BYTES]
    require(ok, f"[23] no directory has {P23_DISK_BYTES / 1e9:.0f} GB free "
            f"for phase 23's files: (free GB, write GB/s) {rates}")
    best = max(ok, key=lambda b: rates[b][1])
    for b, tmp in dirs.items():
        if b != best:
            tmp.cleanup()
    print(f"[23] phase 23's files under {best} (free GB, write GB/s of 256 "
          f"MB with fsync: {rates})", flush=True)
    return dirs[best], rates


def vtk_walk(path: str) -> tuple[tuple, list]:
    """((nx, ny, nz), the field names in order) of a binary
    STRUCTURED_POINTS file, walked header by header over each field's
    big-endian f4 block; the walk must end at the file's last byte."""
    import numpy as np

    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        head = fh.read(4096)
        end = head.index(b"\n", head.index(b"POINT_DATA")) + 1
        lines = head[:end].decode().splitlines()
        require(lines[0] == "# vtk DataFile Version 2.0"
                and lines[2] == "BINARY", f"VTK header {lines}")
        dims = tuple(int(v) for v in lines[4].split()[1:])
        n = int(np.prod(dims))
        pos, names = end, []
        while pos < size:
            fh.seek(pos)
            chunk = fh.read(256)
            line = chunk[:chunk.index(b"\n")]
            kind, name, _ = line.decode().split()
            pos += len(line) + 1
            if kind == "SCALARS":
                require(chunk[len(line) + 1:].startswith(
                    b"LOOKUP_TABLE default\n"), f"VTK {name}: no lookup table")
                pos += len(b"LOOKUP_TABLE default\n")
            pos += 4 * n * (3 if kind == "VECTORS" else 1)
            fh.seek(pos)
            require(fh.read(1) == b"\n", f"VTK {name}: no newline at {pos}")
            pos += 1
            names.append(name)
    require(pos == size, f"VTK walk ended at {pos} of {size} bytes")
    return dims, names


def p23_outputs(device, spec, work) -> dict:
    """23a: demo_512_outputs' stages at its defaults on the 512^3 spec:
    counters reset just before and read just after each stage; the
    original run kept alive, stepped P23_RESUME more steps beside the
    restored one, bit-equal."""
    import numpy as np
    import torch

    from lbm_tpu_torch.engine import checkpoint
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.tools import demo_512_outputs as D

    tag = "[23a] demo_512_outputs 512^3"
    stages, clock = {}, [time.perf_counter()]

    def stage(name):
        now = time.perf_counter()
        stages[name] = now - clock[0]
        clock[0] = now

    n = spec.shape[0]
    live = D.live_cells(spec)
    base = mem_start(device)
    t0 = time.perf_counter()
    sim = D.make_sim(spec, device, False)  # lowmem by its size
    setup_s = time.perf_counter() - t0
    route = K.counter_name(sim.cc)
    require(route.startswith("lbm_collide_stream_list["),
            f"{tag}: the step takes {route}, not the list K1")
    K.reset_launches()
    vs1, first_s = D.chunk(sim, P23_STEPS)
    vs2, elapsed = D.chunk(sim, P23_STEPS)
    torch.cuda.synchronize()
    run_counts = dict(K.launches)
    require(run_counts == {route: 2 * P23_STEPS},
            f"{tag}: launches {run_counts} (want {route} {2 * P23_STEPS}, "
            "no fixup)")
    dt = elapsed / P23_STEPS
    stage("set-up and 40 steps")
    K.reset_launches()
    umax = D.u_max(sim)
    macro_counts = dict(K.launches)
    u_in = 0.1745 / 2.74909090909091
    require(macro_counts == {"lbm_macro": 1} and 0 < umax <= 3 * u_in,
            f"{tag}: macro() launches {macro_counts}, |u|max {umax}")
    stage("macro")
    w = D.wss_stats(sim)
    stage("wss")
    require(sim._wss_via_sparse() and np.isfinite(w["max_pa"])
            and w["max_pa"] > 0, f"{tag}: wss {w}")
    avail = mem_available_gb()
    require(avail > P23_HOST_GB, f"{tag}: host MemAvailable {avail:.1f} GB "
            f"< {P23_HOST_GB} GB for the checkpoint's read and load")
    free = shutil.disk_usage(work).free
    need = (5 * n**3 + 19 * n**3) * 4 * 1.05  # the VTK's fields, then f
    require(free > need, f"{tag}: {free / 1e9:.1f} GB free under {work}, "
            f"< {need / 1e9:.1f} GB for the VTK and the checkpoint")
    K.reset_launches()
    path, vtk_s = D.write_vtk(sim, work)
    vtk_counts = dict(K.launches)
    dims, names = vtk_walk(path)
    vtk_bytes = os.path.getsize(path)
    crops = spec.vtk_crops
    require(vtk_counts.get("lbm_macro", 0) >= 1 and names == [
        "DENSITY", "PRESSURE", "VELOCITY"] and dims == tuple(
            s - 2 * c for s, c in zip(spec.shape, crops)),
        f"{tag}: VTK {dims} {names}, launches {vtk_counts}")
    os.remove(path)
    stage("vtk")
    cpath = os.path.join(work, D.CKPT_NAME)
    K.reset_launches()
    ck_s = D.write_checkpoint(sim, cpath)
    ck_counts = dict(K.launches)
    ck_bytes = os.path.getsize(cpath)
    n_chunks = -(-n // K.chunk_rows(spec.shape))
    require(ck_counts == {"lbm_extract_rows": n_chunks},
            f"{tag}: the checkpoint's save launched {ck_counts} (want K4 "
            f"{n_chunks})")
    stage("checkpoint")
    t1 = time.perf_counter()
    sim2 = D.make_sim(spec, device, False)
    t2 = time.perf_counter()
    checkpoint.restore(sim2, cpath)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t2
    os.remove(cpath)
    K.reset_launches()
    r2, _ = D.chunk(sim2, P23_RESUME)
    torch.cuda.synchronize()
    resume_counts = dict(K.launches)
    r1, _ = D.chunk(sim, P23_RESUME)
    torch.cuda.synchronize()
    require(resume_counts == {route: P23_RESUME}
            and sim2.t == sim.t == 2 * P23_STEPS + P23_RESUME
            and torch.equal(sim.f, sim2.f) and np.array_equal(r1, r2),
            f"{tag}: the resumed run ({resume_counts}, t {sim2.t}) is not "
            "bit-equal to the original stepped the same steps")
    stage("restore and resume")
    peak = peak_gib(device, base)
    state_gb = sim.f.numel() * 4 / 1e9
    out = {"velsum": float(vs1.sum()), "velsum_series": vs1[:2].tolist(),
           "ms": dt * 1e3, "mlups_live": live / dt / 1e6,
           "mlups_box": n**3 / dt / 1e6, "first_chunk_s": first_s,
           "setup_s": setup_s, "u_max": umax, "wss": w,
           "vtk_s": vtk_s, "vtk_gb_per_s": vtk_bytes / vtk_s / 1e9,
           "vtk_bytes": vtk_bytes, "ckpt_write_s": ck_s,
           "ckpt_gb_per_s": ck_bytes / ck_s / 1e9, "ckpt_bytes": ck_bytes,
           "restore_setup_s": t2 - t1, "ckpt_read_s": read_s,
           "peak_gib": peak, "host_mem_available_gb": avail,
           "launches": {"run": run_counts, "macro": macro_counts,
                        "vtk": vtk_counts, "checkpoint": ck_counts,
                        "resume": resume_counts},
           "live": live, "fluid": int(sim.cc.fluid_cells.numel()),
           "stage_s": stages}
    print(f"{tag} ({live} non-DEAD cells, {out['fluid']} fluid; lowmem; "
          f"set-up {setup_s:.1f} s, the first chunk {first_s:.1f} s): "
          f"{dt * 1e3:.4f} ms/step ({P23_STEPS} steps, host clock, "
          f"synchronized), {out['mlups_live']:.0f} MLUPS(live), "
          f"{out['mlups_box']:.0f} MLUPS(box); velsum of the first chunk "
          f"{out['velsum']:.6e}; |u|max {umax:.4f}; wss() first call "
          f"{w['seconds']:.2f} s, {w['count']} cells, mean {w['mean_pa']:.3f}"
          f" Pa, max {w['max_pa']:.3f} Pa; VTK {vtk_bytes / 1e9:.2f} GB in "
          f"{vtk_s:.1f} s ({out['vtk_gb_per_s']:.2f} GB/s), {dims} "
          f"{names}; checkpoint {ck_bytes / 1e9:.2f} GB written in "
          f"{ck_s:.1f} s ({out['ckpt_gb_per_s']:.2f} GB/s, {n_chunks} K4 "
          f"chunks), restored in {read_s:.1f} s (+ {t2 - t1:.1f} s of "
          f"set-up); the resumed {P23_RESUME} steps bit-equal to the "
          f"original's; 2 x {state_gb:.1f} GB states x 2 runs, peak device "
          f"memory {peak:.2f} GiB; host MemAvailable {avail:.1f} GB; "
          f"launches {out['launches']}; seconds by stage "
          f"{ {k: round(v, 1) for k, v in stages.items()} }", flush=True)
    del sim, sim2
    free_device()
    return out


def p23_sharded(spec_dir, work, ref_velsum) -> tuple[dict, str]:
    """23c: demo_512_sharded at its defaults (P23_RANKS gloo ranks sharing
    the card, P23_SHARD_STEPS steps) on the 512^3 spec: its checks, K1d
    over each rank's fluid cells once a step, the steps' velsums within
    1e-5 of 23a's unsharded run's, and each rank's window's first and last
    y rows written for 23b. Returns (the numbers, the rows' directory)."""
    import numpy as np

    from lbm_tpu_torch.tools import demo_512_sharded as S

    tag = f"[23c] demo_512_sharded 512^3 on y, {P23_RANKS} gloo ranks"
    rows_dir = tempfile.mkdtemp(prefix="rows_", dir=work)
    t0 = time.perf_counter()
    ranks = S.run_sharded(spec_dir, P23_RANKS, P23_SHARD_STEPS, "cuda",
                          timeout=600, rows_dir=rows_dir)
    wall_s = time.perf_counter() - t0
    out = S.report(ranks, P23_N, P23_RANKS)
    k1d = "lbm_collide_stream_list[bgk+halo]"
    require(all(c == {k1d: P23_SHARD_STEPS} for c in out["launches"]),
            f"{tag}: launches {out['launches']} (want {k1d} "
            f"{P23_SHARD_STEPS} on every rank)")
    v_rel = float(np.max(np.abs(np.asarray(out["velsum"])
                                - np.asarray(ref_velsum))
                         / np.abs(ref_velsum)))
    require(v_rel <= 1e-5, f"{tag}: velsum {out['velsum']} against the "
            f"unsharded {ref_velsum}: rel err {v_rel:.3e} > 1e-5")
    out.update(velsum_rel_err=v_rel, wall_s=wall_s,
               setup_s=max(r["setup_s"] for r in ranks),
               peak_gib=max(r["peak_gib"] for r in ranks),
               exchange_share=max(out["exchange_ms"]) / max(out["ms"]))
    print(f"{tag}: velsum rel err against 23a's unsharded steps "
          f"{v_rel:.3e}; per-rank ms/step {[round(m, 3) for m in out['ms']]}"
          f", the exchange alone {[round(e, 3) for e in out['exchange_ms']]}"
          f" ms ({out['exchange_share']:.1%} of the slowest step); set-up "
          f"{out['setup_s']:.1f} s a rank, peak device memory "
          f"{out['peak_gib']:.2f} GiB a rank; {wall_s:.1f} s with the spawn",
          flush=True)
    return out, rows_dir


def p23_washout(device, spec, rows_dir) -> dict:
    """23b: demo_512_washout at its defaults on the 512^3 spec; its flow's
    first P23_SHARD_STEPS steps first, against which 23c's rows are held
    bit for bit (zeros at DEAD cells, as f_standard() has them); K7 and
    the record counted; phase 9's washout checks; a profile."""
    import numpy as np
    import torch

    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.geometry.mask import CellType
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.kernels import scalar_stream as S
    from lbm_tpu_torch.tools import demo_512_washout as W

    tag = "[23b] demo_512_washout 512^3"
    base = mem_start(device)
    t0 = time.perf_counter()
    sim = Simulation(spec, device=device, backend="kernel")
    setup_s = time.perf_counter() - t0
    K.reset_launches()
    sim.run(max_steps=P23_SHARD_STEPS, time_save=P23_SHARD_STEPS,
            verbose=False)
    dead = sim.cc.mask == CellType.DEAD
    rows = spec.shape[1] // P23_RANKS
    n_rows = 0
    for r in range(P23_RANKS):
        saved = np.load(os.path.join(rows_dir, f"rows_{r}.npy"))
        for k, y in enumerate((r * rows, r * rows + rows - 1)):
            want = torch.where(dead[:, y], 0.0, sim.f[:, :, y])
            require(torch.equal(torch.from_numpy(saved[k]).to(device), want),
                    f"{tag}: rank {r}'s y row {y} after {P23_SHARD_STEPS} "
                    "steps differs from the unsharded state's")
            n_rows += 1
    res = W.run_flow(sim, P23_FLOW - P23_SHARD_STEPS)
    torch.cuda.synchronize()
    flow_counts = dict(K.launches)
    route = K.counter_name(sim.cc)
    require(flow_counts.get(route) == P23_FLOW,
            f"{tag}: flow launches {flow_counts}")
    flow_ms = res.elapsed_s / res.steps * 1e3
    u = sim.macro()[1]
    del sim
    free_device()
    t0 = time.perf_counter()
    st = W.transport(spec, u, P23_BOLUS, device)
    del u
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    rec = list(range(len(spec.boundaries)))
    S.reset_launches()
    warm, timed, nst, elapsed = W.washout(st, P23_WASHOUT, P23_CHUNK, rec)
    counts = dict(S.launches)
    k7 = "lbm_scalar_stream[frozen]"
    require(counts == {k7: P23_WASHOUT}, f"{tag}: transport launches "
            f"{counts} (want {k7} {P23_WASHOUT}, the record in each)")
    series = np.concatenate([warm, timed], axis=0)
    check_washout(tag, st, series, P23_BOLUS)
    ms = elapsed / nst * 1e3
    peaks = [float(timed[:, k].max()) for k in rec]
    by_name, busy = profile_steps(lambda: st.run(200, record=rec), 200)
    print_profile(tag, by_name, busy, ms)
    prof = path_profile(tag, by_name, ms, 2)
    peak = peak_gib(device, base)
    listed = st.sc.cells.numel() if st.sc.cells is not None else None
    print(f"{tag}: flow {P23_FLOW} steps at {flow_ms:.4f} ms/step ({route}, "
          f"set-up {setup_s:.1f} s); {n_rows} rows of 23c's ranks bit-equal "
          f"to the unsharded state after {P23_SHARD_STEPS} steps; transport "
          f"set-up {t_setup:.1f} s ({listed} cells listed), {nst} timed "
          f"steps at {ms:.4f} ms/step (host clock, synchronized); series "
          f"peaks {[round(p, 4) for p in peaks]}, total() {st.total():.2f}; "
          f"peak device memory {peak:.2f} GiB; launches {counts}",
          flush=True)
    out = dict(prof, flow_ms=flow_ms, flow_launches=flow_counts.get(route),
               transport_ms=ms, peaks=peaks, total=st.total(),
               peak_gib=peak, launches=counts, rows_bit_equal=n_rows,
               listed_cells=listed)
    del st
    free_device()
    return out


def p23_clinical(device) -> dict:
    """23d: profile_clinical at its defaults, each row's launches a step
    from the counters (a run of its --steps, counters reset just before
    and read just after) held to the bounds of phases 5, 10 and 18, a
    1-step run's wall ms (what a run costs beyond its steps), and its
    collide-stream kernel's device ms from one _profile_window of 200
    steps."""
    import torch

    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.kernels import scalar_stream as S
    from lbm_tpu_torch.tools import profile_clinical as P

    args = P.parse_args([])
    shape = tuple(int(s) for s in args.shape.split(","))
    out, prev = {}, None
    for name in P.ROWS:
        tag = f"[23d] profile_clinical {name}"
        t0 = time.perf_counter()
        kind, spec = P.row_spec(name, shape, args.radius)
        obj, run = P.make_row(kind, spec, device)
        ms = P.time_row(run, args.steps)
        total = time.perf_counter() - t0
        K.reset_launches()
        S.reset_launches()
        run(args.steps)
        torch.cuda.synchronize()
        counts = {**K.launches, **S.launches}
        cc = obj.cc
        route = K.counter_name(cc)
        wk = "+wk" in route
        per_step = {k: v / args.steps for k, v in counts.items()}
        once = {k: v for k, v in counts.items()
                if k not in (route, "lbm_scalar_stream[live]")}
        require(counts.get(route) == args.steps
                and (kind != "coupled" or counts.get(
                    "lbm_scalar_stream[live]") == args.steps)
                and all(v <= 1 for v in once.values())
                and (not wk or once.get("lbm_windkessel_flux") == 1)
                and not [k for k in counts if "fix_z_plane" in k],
                f"{tag}: launches {counts} over {args.steps} steps")
        # what a run costs beyond its steps: a 1-step run's wall time
        t1 = time.perf_counter()
        run(1)
        one_ms = (time.perf_counter() - t1) * 1e3
        by_name, busy, fill = _profile_window(lambda: run(200), 200)
        dev = {short_name(k): v[0] / v[1] for k, v in by_name.items()
               if v[1] and ("collide_stream" in k)}
        note = "" if prev is None else f" (delta {ms - prev:+.2f})"
        print(f"{name:<14} {ms:6.2f} ms/step{note}  [total incl. set-up "
              f"{total:.0f}s]; {route}: launches a step {per_step}; device "
              f"ms a launch {dev}; busy {busy:.3f}; fillers seen {fill}; "
              f"a 1-step run {one_ms:.3f} ms", flush=True)
        out[name] = {"ms": ms, "total_s": total, "route": route,
                     "one_step_run_ms": one_ms,
                     "launches": counts, "launches_per_step": per_step,
                     "k1_device_ms": dev, "busy": busy}
        prev = ms
        del obj, run
        free_device()
    return out


def p23_shard(device) -> dict:
    """23e: profile_shard at its defaults, each variant's launches over
    one more run of its --steps (counters reset just before and read just
    after): K1a for v1, K1d over the box for v2-v4, once a step."""
    import torch

    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.tools import profile_shard as P

    args = P.parse_args([])
    counts = {}

    def hook(name, step, f):
        out = f.clone()
        series = torch.zeros(args.steps, dtype=torch.float64, device=f.device)
        K.reset_launches()
        for k in range(args.steps):
            step(f, out, series, k, k)
            f, out = out, f
        torch.cuda.synchronize()
        counts[name] = dict(K.launches)

    res = P.variants(args.n, device, set(args.variants.split(",")),
                     args.steps, hook=hook)
    n3 = args.n ** 3
    for name, dt in res.items():
        c = counts[name]
        halo = name != "v1_unsharded"
        require(len(c) == 1 and list(c.values()) == [args.steps]
                and list(c)[0].endswith("+halo]") == halo,
                f"[23e] profile_shard {name}: launches {c}")
        print(f"{name}: {dt * 1e3:.2f} ms/step, {n3 / dt / 1e6:.0f} MLUPS; "
              f"launches {c}", flush=True)
    return {name: {"ms": dt * 1e3, "mlups": n3 / dt / 1e6,
                   "launches": counts[name]} for name, dt in res.items()}


def p23_spec_start(work_dir: str) -> tuple:
    """Start building the 512^3 spec in a process of its own, which writes
    it to work_dir/spec (demo_512_sharded.save_spec): the build's ~15 s of
    host work run beside the card's phases. Returns what p23_spec_wait
    takes."""
    spec_dir = os.path.join(work_dir, "spec")
    os.mkdir(spec_dir)
    code = ("import sys, time\n"
            "t0 = time.perf_counter()\n"
            "from lbm_tpu_torch.tools import coronary_cube\n"
            "from lbm_tpu_torch.tools import demo_512_sharded as S\n"
            "S.save_spec(coronary_cube(int(sys.argv[1])), sys.argv[2])\n"
            "print(f'{time.perf_counter() - t0:.1f}')\n")
    proc = child(subprocess.Popen(
        [sys.executable, "-c", code, str(P23_N), spec_dir],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    return proc, spec_dir, time.perf_counter()


def p23_spec_wait(started) -> tuple:
    """(the spec p23_spec_start's process wrote, mapped read-only; its
    directory; the process's seconds; the seconds waited for it)."""
    from lbm_tpu_torch.tools import demo_512_sharded as S

    proc, spec_dir, t0 = started
    t1 = time.perf_counter()
    out, _ = proc.communicate(timeout=900)
    require(proc.returncode == 0, f"[23] the 512^3 spec's process failed "
            f"({proc.returncode}):\n{out}")
    waited = time.perf_counter() - t1
    spec = S.load_spec(spec_dir)
    print(f"[23] coronary {P23_N}^3 spec (radius {max(6, P23_N // 36)}) "
          f"built and written in a process of its own in "
          f"{float(out.split()[-1]):.1f} s, started "
          f"{t1 - t0:.1f} s before phase 23; waited {waited:.1f} s",
          flush=True)
    return spec, spec_dir, float(out.split()[-1]), waited


def phase23(device, work, disk, started) -> dict:
    """Phase 23: the 512^3 demos and the profile tools (23a, 23c, 23b,
    23d, 23e) in the TemporaryDirectory `work` (p23_workdir, its write
    rates `disk`); the 512^3 spec the process `started`
    (p23_spec_start) wrote there serves 23a-23c."""
    spec, spec_dir, spec_s, waited = p23_spec_wait(started)
    out = {"spec_s": spec_s, "spec_waited_s": waited, "disk": disk}
    try:
        out["a"] = p23_outputs(device, spec, work.name)
        mark("23a")
        out["c"], rows_dir = p23_sharded(spec_dir, work.name,
                                         out["a"]["velsum_series"])
        mark("23c")
        out["b"] = p23_washout(device, spec, rows_dir)
        mark("23b")
    finally:
        del spec
        work.cleanup()
    out["d"] = p23_clinical(device)
    mark("23d")
    out["e"] = p23_shard(device)
    mark("23e")
    return out


def phase23_main() -> int:
    """`chip_smoke.py --phase23`: phase 23 alone on one card (the card's
    name and power limit first), the kernels built side by side with the
    512^3 spec's process."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --phase23: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    from lbm_tpu_torch.kernels import _build

    work, disk = p23_workdir()
    started = p23_spec_start(work.name)
    lib = _build.load_library()
    print(f"[23] kernels {'built' if lib.built else 'found'} in "
          f"{lib.build_seconds:.2f} s", flush=True)
    res = phase23(torch.device("cuda", 0), work, disk, started)
    print(json.dumps({"phase23": res}, default=float), flush=True)
    print(f"[done] phase 23 in {time.perf_counter() - T_START:.1f} s",
          flush=True)
    return 0


def phase21_main() -> int:
    """`chip_smoke.py --phase21`: phase 21 alone on one card (the card's
    name and power limit first), 21a's kernel run building what it
    needs."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --phase21: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    res = phase21_during_build(device)
    res["21a"].update(adjoint_verify(device, res["21a"].pop("theta")))
    print(json.dumps({"phase21": res}, default=float), flush=True)
    print(f"[done] phase 21 in {time.perf_counter() - T_START:.1f} s",
          flush=True)
    return 0


def phase22_main() -> int:
    """`chip_smoke.py --phase22`: phase 22 alone on one card (the card's
    name and power limit first), its first kernel launch building the
    kernels."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --phase22: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    res = bifurcation_path(torch.device("cuda", 0))
    print(json.dumps({"phase22": res}, default=float), flush=True)
    print(f"[done] phase 22 in {time.perf_counter() - T_START:.1f} s",
          flush=True)
    return 0


def nccl_main() -> int:
    """`chip_smoke.py --nccl`: phase 17 alone on every card (two or
    more), the card's name and power limit first."""
    import torch

    from lbm_tpu_torch.cases import get_case

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"chip_smoke --nccl: needs two or more CUDA cards, found "
              f"{n_cards}", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    nccl_path(n_cards, get_case("coronary", **FULL_CORONARY))
    print(f"[done] phase 17 on {n_cards} cards in "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)
    return 0


def main() -> int:
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 yardsticks
    # the modules the phases import, then gc.freeze(): free_device's ~200
    # gc.collect() calls scan only what the run itself made
    import torch.distributed  # noqa: F401
    import torch.profiler  # noqa: F401

    import lbm_tpu_torch.engine.scalar  # noqa: F401
    import lbm_tpu_torch.engine.sparse  # noqa: F401
    import lbm_tpu_torch.engine.stress  # noqa: F401
    import lbm_tpu_torch.engine.thermal  # noqa: F401
    import lbm_tpu_torch.parallel.launch  # noqa: F401
    gc.freeze()

    # -- phase 1: card and toolchain ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import collide_stream as K

    nvcc = _build.nvcc_path()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip().splitlines()[-1]
    print(f"[1] {torch.cuda.get_device_name(0)}; nvcc {nvcc}: "
          f"{nvcc_version}; torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); python {sys.version.split()[0]}",
          flush=True)

    # -- phase 2: build; meanwhile phase 19's and phase 20's kernel-free ---
    # parts. Phase 20's files live until phase 17, which runs its (a) over
    # NCCL
    p20_dir = tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(_build.load_library)
        # phase 8's `run --shard 1`: a process of its own (it spawns its
        # rank over NCCL; ~30 s, most of it start-up), started here so its
        # start-up runs beside the build; its rank waits for the build's
        # lock, and phase 8 checks what it wrote
        shard_cli = cli_shard_start()
        p21 = phase21_during_build(device)
        curved_a = curved_sparse_dense(device)
        p20_dense = sharded_dense_references(device, p20_dir.name)
        lib = building.result()
    print(f"[2] kernels {'built' if lib.built else 'found'} at "
          f"{os.path.relpath(lib.path, ROOT)} in {lib.build_seconds:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    slib = _build.load_scalar_library()
    print(f"[2] scalar kernels {'built' if slib.built else 'found'} at "
          f"{os.path.relpath(slib.path, ROOT)} in {slib.build_seconds:.2f} s, "
          "side by side with the collide-stream library", flush=True)
    plib = _build.load_pair_library()
    pair_smem = plib.lib.lbm_pair_smem_bytes()
    pair_unit = tuple(plib.lib.lbm_pair_unit(a) for a in range(3))
    print(f"[2] fused-pair and row-extract kernels "
          f"{'built' if plib.built else 'found'} at "
          f"{os.path.relpath(plib.path, ROOT)} in {plib.build_seconds:.2f} s, "
          f"side by side; K2 unit: an x segment of {pair_unit[0]} planes of "
          f"a {pair_unit[1]} x {pair_unit[2]} (y, z) column tile, "
          f"{plib.lib.lbm_pair_block_size()} threads, {pair_smem} bytes of "
          "dynamic shared memory a block", flush=True)
    blib = _build.load_library(bf16=True)
    bplib = _build.load_pair_library(bf16=True)
    print(f"[2] bf16 kernels {'built' if blib.built else 'found'} at "
          f"{os.path.relpath(blib.path, ROOT)} in {blib.build_seconds:.2f} s "
          f"and {os.path.relpath(bplib.path, ROOT)} in "
          f"{bplib.build_seconds:.2f} s, side by side: five nvcc processes, "
          f"the slowest {max(L.build_seconds for L in (lib, slib, plib, blib, bplib)):.2f} s",
          flush=True)
    smem, stack = {}, {}
    ptxas = ptxas_report(lib.log + "\n" + slib.log + "\n" + plib.log, smem,
                         stack=stack)
    ptxas_bf16 = ptxas_report(blib.log + "\n" + bplib.log, smem, "bf16",
                              stack=stack)
    pair_occ = {**pair_blocks_per_sm(plib.lib, ""),
                **pair_blocks_per_sm(bplib.lib, "bf16")}
    for name, (regs, spill_st, spill_ld) in sorted(ptxas.items()) + sorted(
            ptxas_bf16.items()):
        extra = (f"; {smem.get(name, 0)} + {pair_smem} dynamic bytes smem, "
                 f"{pair_occ.get(name)} blocks an SM"
                 if name.startswith("collide_stream2") else "")
        print(f"[2] ptxas {name}: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads{extra}", flush=True)
    require(len(pair_occ) == 28 and all(n >= 1 for n in pair_occ.values()),
            f"K2 blocks an SM: {pair_occ}")
    n_bf16 = {k: sum(n.startswith(k + "[") for n in ptxas_bf16)
              for k in ("collide_stream_pair_kernel", "collide_stream_kernel",
                        "fix_z_plane_kernel", "collide_stream2_kernel",
                        "macro_kernel")}
    require(n_bf16 == {"collide_stream_pair_kernel": 28,
                       "collide_stream_kernel": 0, "fix_z_plane_kernel": 0,
                       "collide_stream2_kernel": 14, "macro_kernel": 2}
            and "extract_rows_kernel[bf16]" in ptxas_bf16,
            f"ptxas reported bf16 instances {n_bf16} (want 28 paired, no "
            "per-cell, none, 14, 2) and K4 bf16 "
            f"{'extract_rows_kernel[bf16]' in ptxas_bf16}")
    k2_ptxas = {k: v for k, v in ptxas.items()
                if k.startswith("collide_stream2_kernel")}
    require(len(k2_ptxas) == 14 and any(
        k.startswith("extract_rows_kernel") for k in ptxas),
        f"ptxas reported {len(k2_ptxas)} K2 instances (want 14) and no K4"
        if len(k2_ptxas) != 14 else "ptxas reported no K4 kernel")
    bgk = ptxas.get("collide_stream_kernel[bgk]")
    bgk16 = ptxas_bf16.get("collide_stream_pair_kernel[bgk+bf16]")
    require(bgk is not None and bgk16 is not None,
            "ptxas reported no BGK collide-stream instance")
    k1_blocks = {k: blocks_per_sm(v[0]) for k, v in
                 list(ptxas.items()) + list(ptxas_bf16.items())
                 if k.startswith(("collide_stream_kernel[",
                                  "collide_stream_pair_kernel["))}
    # the lid main path must not pay for the branches it never takes, nor
    # the vessel paths for their z planes: at most 80 registers, no spill,
    # no stack frame (the z descriptors' loop indexes a __grid_constant__
    # parameter, so nothing is copied) and three blocks an SM, with and
    # without the z planes' code; the paired bf16 kernel is built for
    # three blocks an SM (80 registers: at 128 and two blocks its first
    # form ran 23% slower on the lid, probes/bf16_k1_ab.py), its few
    # spilled words printed
    for name in ("collide_stream_kernel[bgk]", "collide_stream_kernel[bgk+z]",
                 "collide_stream_pair_kernel[bgk+bf16]",
                 "collide_stream_pair_kernel[bgk+z+bf16]"):
        regs, st, ld = {**ptxas, **ptxas_bf16}[name]
        paired = "pair" in name
        require(regs <= 80 and (paired or st + ld == 0 and
                                stack.get(name, 0) == 0)
                and k1_blocks[name] >= 3,
                f"{name}: {regs} registers, {st} + {ld} bytes spilled, "
                f"{stack.get(name)} bytes of stack frame, {k1_blocks[name]} "
                "blocks an SM: not at most 80, 0, 0 (the paired kernel: any) "
                "and at least 3")
    print("[2] the BGK collide-stream instance (registers, spill bytes, "
          "stack frame bytes, blocks of 256 threads an SM): " + "; ".join(
              f"{n} {v[0]}, {v[1] + v[2]}, {stack.get(n)}, {k1_blocks[n]}"
              for n, v in sorted({**ptxas, **ptxas_bf16}.items())
              if n.startswith(("collide_stream_kernel[bgk]",
                               "collide_stream_kernel[bgk+z",
                               "collide_stream_pair_kernel[bgk+"))),
          flush=True)
    # the windkessel units: the fold's 14 instances in each storage type
    # and its reduction; the flux kernel that primes the fold, fp32 and
    # bf16
    wlib = _build.load_wk_library()
    wlib16 = _build.load_wk_library(bf16=True)
    ptxas_wk = {**ptxas_report(wlib.log, stack=stack),
                **ptxas_report(wlib16.log, tag="bf16", stack=stack)}
    fold_blocks = {k: blocks_per_sm(v[0]) for k, v in ptxas_wk.items()
                   if k.startswith("collide_stream_kernel[")}
    for name, (regs, spill_st, spill_ld) in sorted(ptxas_wk.items()):
        extra = (f", {stack.get(name)} bytes of stack frame, "
                 f"{fold_blocks[name]} blocks an SM"
                 if name in fold_blocks else "")
        print(f"[2] ptxas {name}: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads{extra}", flush=True)
    flux_insts = {k for k in ptxas_wk
                  if k.startswith("windkessel_flux_kernel")}
    require(flux_insts == {
        f"windkessel_flux_kernel[{k}]" for k in
        ("force", "force+bf16", "plain", "plain+bf16")}
        and len(fold_blocks) == 28
        and all("+wk" in k for k in fold_blocks)
        and {"velsum_reduce_wk_kernel",
             "velsum_reduce_wk_kernel[bf16]"} <= set(ptxas_wk),
        f"ptxas reported windkessel kernels {sorted(ptxas_wk)} (want 4 flux "
        "kernels, 28 fold instances and the fold's reduction in each "
        "storage type)")
    print(f"[2] windkessel units built at {os.path.relpath(wlib.path, ROOT)} "
          f"in {wlib.build_seconds:.2f} s and "
          f"{os.path.relpath(wlib16.path, ROOT)} in "
          f"{wlib16.build_seconds:.2f} s; the fold [bgk+wk] "
          f"{ptxas_wk['collide_stream_kernel[bgk+wk]']} against [bgk+z] "
          f"{ptxas['collide_stream_kernel[bgk+z]']} (registers, spill "
          "bytes)", flush=True)
    # the sharded step (K1d): one unit per shard axis, side by side
    hlibs = [_build.load_halo_library(a) for a in (0, 1)]
    ptxas_halo = {}
    for hl, tag in zip(hlibs, ("halo_x", "halo_y")):
        ptxas_halo.update(ptxas_report(hl.log, tag=tag))
    slowest = max(L.build_seconds for L in (
        lib, slib, plib, blib, bplib, wlib, wlib16,
        _build.load_list_library(), *hlibs))
    print(f"[2d] sharded-step kernels (K1d) built at "
          f"{[os.path.relpath(h.path, ROOT) for h in hlibs]} in "
          f"{[round(h.build_seconds, 2) for h in hlibs]} s, side by side "
          f"with the others (ten nvcc processes, the slowest "
          f"{slowest:.2f} s)", flush=True)
    for name, (regs, spill_st, spill_ld) in sorted(ptxas_halo.items()):
        print(f"[2d] ptxas {name}: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads", flush=True)
    n_halo = {k: sum(n.startswith(k + "[") for n in ptxas_halo)
              for k in ("collide_stream_kernel", "collide_stream_list_kernel",
                        "fix_z_plane_kernel")}
    require(n_halo == {"collide_stream_kernel": 56,
                       "collide_stream_list_kernel": 28,
                       "fix_z_plane_kernel": 0},
            f"ptxas reported halo instances {n_halo} (want 56 over the box, "
            "28 over the fluid cells and none)")
    # the fp32 launch over the fluid cells (its own unit): its 18
    # instances against LIST_PTXAS, and the shards' 28 against
    # HALO_LIST_PTXAS, each at 768 threads an SM or more
    llib = _build.load_list_library()
    list_ptxas = {k: v for k, v in ptxas_report(llib.log,
                                                stack=stack).items()
                  if k.startswith("collide_stream_list_kernel[")}
    halo_list = {k: v for k, v in ptxas_halo.items()
                 if k.startswith("collide_stream_list_kernel[")}
    list_threads = llib.lib.lbm_list_block_size()
    list_blocks = {k: blocks_per_sm(v[0], list_threads)
                   for k, v in {**list_ptxas, **halo_list}.items()}
    for name, (regs, spill_st, spill_ld) in sorted(list_ptxas.items()):
        print(f"[2] ptxas {name}: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads, {stack.get(name)} "
              f"bytes of stack frame, {list_blocks[name]} blocks an SM",
              flush=True)
    print(f"[2] the launch over the fluid cells built at "
          f"{os.path.relpath(llib.path, ROOT)} in {llib.build_seconds:.2f} "
          "s, side by side with the others", flush=True)
    moved = {k: (v, LIST_PTXAS.get(k)) for k, v in list_ptxas.items()
             if LIST_PTXAS.get(k) != v}
    moved.update({k: (v, HALO_LIST_PTXAS.get(k)) for k, v in halo_list.items()
                  if HALO_LIST_PTXAS.get(k) != v})
    require(len(list_ptxas) == 18 and not moved and min(
        list_blocks.values()) * list_threads >= 3 * K1_THREADS,
            f"the list instances not as LIST_PTXAS / HALO_LIST_PTXAS have "
            f"them, or under {3 * K1_THREADS} threads an SM: {moved}, "
            f"{len(list_ptxas)} instances, blocks of {list_threads} threads "
            f"{list_blocks}")
    # the unsharded instances against the table of this build's: any
    # change to their registers or spills shows
    unsharded = {k: v for k, v in ptxas.items()
                 if k.startswith(("collide_stream_kernel[",
                                  "fix_z_plane_kernel["))}
    moved = {k: (v, BASE_PTXAS.get(k)) for k, v in unsharded.items()
             if BASE_PTXAS.get(k) != v}
    print("[2d] unsharded fp32 instances, registers + spill bytes, stack "
          "frame bytes and blocks an SM: " + "; ".join(
              f"{k} {v[0]}+{v[1] + v[2]}, {stack.get(k)}, {k1_blocks[k]}"
              for k, v in sorted(unsharded.items())), flush=True)
    require(len(unsharded) == 36 and not moved,
            f"unsharded instances not as BASE_PTXAS has them: {moved}")
    # K1e [trt+field] and its z and moving variants: three blocks an SM
    # (the per-direction loop and the launch bound)
    trt_field = {k: v for k, v in unsharded.items()
                 if k.startswith("collide_stream_kernel[trt+field")}
    require(len(trt_field) == 4 and all(
        v[0] <= 80 and k1_blocks[k] >= 3 for k, v in trt_field.items()),
        f"K1e [trt+field*] not at three blocks an SM: {trt_field}")
    print("[2] K1e [trt+field*] (registers, spill store + load bytes, stack "
          "frame bytes, blocks an SM): " + "; ".join(
              f"{k} {v[0]}, {v[1] + v[2]}, {stack.get(k)}, {k1_blocks[k]}"
              for k, v in sorted(trt_field.items())), flush=True)
    mark("1, 2")
    # phase 23's files and its 512^3 spec, built by a process of its own
    # beside the card's phases
    p23_work, p23_disk = p23_workdir()
    p23_started = p23_spec_start(p23_work.name)
    p21["21a"].update(adjoint_verify(device, p21["21a"].pop("theta")))
    mark("21a (the kernel run)")

    # -- phase 3: kernels vs plain versions --------------------------------
    # the scalar, thermal and K1d checks, then phase 19c, in a process of
    # their own (side_checks) beside the checks below; phase 3's timings
    # start once it has ended, so nothing else shares the card with them
    side_dir = tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_")
    u_path = os.path.join(side_dir.name, "u_full.npy")
    side = side_checks_start(u_path)
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.core.rheology import carreau_blood
    from lbm_tpu_torch.engine.runner import Simulation

    errs = {"K1a": 0.0, "Kz": 0.0, "K3": 0.0}
    compare_case(("lid_driven_cavity", dict(n=64)), 4, device, errs,
                 macro_steps=SMALL_STEPS)
    compare_case(("poiseuille", dict(n=32)), 4, device, errs,
                 macro_steps=SMALL_STEPS)
    small = dict(shape=[64, 48, 96], radius=4)
    compare_case(("coronary", small), 4, device, errs,
                 macro_steps=SMALL_STEPS)
    compare_case(("coronary", dict(small, pulsatile=[4, 40])), SMALL_STEPS,
                 device, errs, macro_steps=SMALL_STEPS)
    compare_case(("curved_vessel", dict(n=64, nphase=4, period_steps=40)), 4,
                 device, errs, macro_steps=SMALL_STEPS)
    compare_case(("lid_driven_cavity", dict(n=256)), 2, device, errs)
    t0 = time.perf_counter()
    full = get_case("coronary", **FULL_CORONARY)
    print(f"[3] full-size coronary spec built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    compare_case(("coronary", FULL_CORONARY), 2, device, errs, spec=full)
    free_device()

    # the collision branches (K1b), 200 steps each
    k1b_errs = {"K1a": 0.0, "Kz": 0.0, "K3": 0.0}
    branch_err = {}
    blood_small = carreau_blood(get_case("coronary", **small).units)
    for label, name, kw, exact in branch_cases(blood_small):
        e = compare_case((name, kw), SMALL_STEPS, device, k1b_errs,
                         macro_steps=SMALL_STEPS,
                         exact=exact, label=f"K1b {label}")
        branch_err[label] = max(e["f"], e["k1a"], e["z"])
        if name == "gravity_channel" or name == "pipe":
            k1b_errs["K3_force"] = max(k1b_errs.get("K3_force", 0.0),
                                       e["k3"])
    refused = get_case("gravity_channel", n=32, nz=32, collision="mrt")
    try:
        Simulation(refused, device=device)
    except NotImplementedError as exc:
        require("backend='dense'" in str(exc),
                f"the MRT + force refusal does not name backend='dense': "
                f"{exc}")
    else:
        raise SmokeFailure("the kernel route ran MRT + force")
    sim = Simulation(refused, device=device, backend="dense")
    res = sim.run(max_steps=200, time_save=100, verbose=False)
    rho, u = sim.macro()
    require(res.steps == 200 and bool(torch.isfinite(u).all())
            and float(u[2][sim.cc.fluid].mean()) > 0,
            "gravity_channel 32^3 MRT + force on the dense backend")
    print(f"[3] K1b gravity_channel 32^3 mrt+force: the kernel route refuses "
          f"it, the dense backend ran 200 steps (mean u_z "
          f"{float(u[2][sim.cc.fluid].mean()):.4e})", flush=True)
    del sim, rho, u
    free_device()
    # the blood and force paths' instances at their own sizes
    blood = get_case("coronary", **FULL_CORONARY, collision="trt",
                     rheology=carreau_blood(full.units))
    for label, case, spec, exact in (
            ("coronary full trt+carreau blood", ("coronary", FULL_CORONARY),
             blood, False),
            ("gravity_channel 256^3 trt+force", ("gravity_channel", dict(
                n=256, nz=256, collision="trt")), None, True)):
        e = compare_case(case, 2, device, k1b_errs, spec=spec, exact=exact,
                         label=f"K1b {label}")
        branch_err[label] = max(e["f"], e["k1a"], e["z"])
        free_device()
    # the last is the force path's: K3 with its force shift
    k1b_errs["K3_force"] = max(k1b_errs["K3_force"], e["k3"])
    print(f"[3] K1b max abs err per branch ({SMALL_STEPS} steps; 2 at the "
          "full sizes): " + "; ".join(f"{k} {v:.3e}" for k, v in
                                      branch_err.items()), flush=True)

    # the fused pair (K2), SMALL_STEPS // 2 launches each against two K1
    # launches and its plain version, then lid 256^3 for 2 launches; K4
    # against its plain version on a stepped 256^3 state; K2 timings
    from lbm_tpu_torch.engine.compile import compile_case

    k2_insts = {K.instance(compile_case(get_case(name, **kw)))
                for _, name, kw, _ in pair_instance_cases()}
    require(len(k2_insts) == 14 and all(
        f"collide_stream2_kernel[{i.replace('smag', 'closure').replace('cy', 'closure')}]"
        in ptxas for i in k2_insts),
        f"the pair's cases reach {sorted(k2_insts)}, not its 14 instances")
    k2_err = {}
    for label, name, kw, exact in pair_cases():
        k2_err[label] = compare_pair(label, get_case(name, **kw),
                                     SMALL_STEPS // 2,
                                     device, exact)
    k2_err["lid 256^3 bgk"] = compare_pair(
        "lid 256^3 bgk", get_case("lid_driven_cavity", n=256), 2, device,
        True)
    k4_err = compare_rows(device)
    # bf16 storage (3d): every bf16 instance against its plain version
    # for 200 steps, K2 bf16 against its plain pair and two bf16 K1
    # launches, K3 and K4 bf16, the paths' shapes for 2 steps; timings
    bf16_err, bf16_diff, bf16_z, bf16_k3 = {}, {}, 0.0, 0.0
    # div_exact's hard divisors (significands of all ones) and 1, then
    # every launch divisor of the bf16 cases
    divisors = {0.99999994, 1.9999999, 0.49999997, 1.0}
    for label, name, kw, exact in bf16_cases():
        e = compare_bf16(label, get_case(name, **kw), SMALL_STEPS, device,
                         exact)
        bf16_err[label] = max(e["f"], e["k1a"], e["z"])
        bf16_diff[label] = e["n_diff"]
        bf16_z, bf16_k3 = max(bf16_z, e["z"]), max(bf16_k3, e["k3"])
        divisors |= e["divisors"]
    for label, spec, exact in (
            ("lid 256^3 bgk", get_case("lid_driven_cavity", n=256), True),
            ("coronary full bgk", full, True)):
        e = compare_bf16(label, spec, 2, device, exact)
        bf16_err[label] = max(e["f"], e["k1a"], e["z"])
        bf16_z, bf16_k3 = max(bf16_z, e["z"]), max(bf16_k3, e["k3"])
        divisors |= e["divisors"]
    div_bad = div_exact_sweeps(sorted(divisors), device)
    k2_bf16 = {}
    for label, spec, launches in (
            ("lid 64^3 bgk", get_case("lid_driven_cavity", n=64),
             SMALL_STEPS // 2),
            ("curved_vessel 64^3 series inlet", get_case(
                "curved_vessel", n=64, nphase=4, period_steps=12),
             SMALL_STEPS // 2),
            ("lid 256^3 bgk", get_case("lid_driven_cavity", n=256), 1)):
        k2_bf16[label] = compare_pair_bf16(label, spec, launches, device)
    for label, name, kw, exact in pair_instance_cases():
        k2_bf16[label] = compare_pair_bf16(label, get_case(name, **kw), 20,
                                           device, exact)
    print("[3d] bf16 max abs err per instance against its plain version "
          f"({SMALL_STEPS} steps; 2 at the full sizes): " + "; ".join(
              f"{k} {v:.3e}" for k, v in bf16_err.items())
          + f"; values differing after {SMALL_STEPS} steps: " + "; ".join(
              f"{k} {v}" for k, v in bf16_diff.items() if v), flush=True)
    mark("3 (K1, K2, K4, bf16 checks)")
    side_res = side_checks_wait(side)
    scalar_err, path_err, halo_err, pipe = (
        side_res[k] for k in ("scalar_err", "path_err", "halo_err", "pipe"))
    print("[3] scalar/thermal max abs err per instance "
          f"({SMALL_STEPS} steps; 2 at "
          "the full sizes): "
          + "; ".join(f"{k} {v:.3e}" for k, v in scalar_err.items())
          + "; at the paths' own shapes: "
          + "; ".join(f"{k} {v:.3e}" for k, v in path_err.items()),
          flush=True)
    u_full = torch.from_numpy(np.load(u_path)).to(device)
    side_dir.cleanup()
    mark("3 (the side process waited for)")

    # phase 3's timings
    t64 = time_lid(64, device, iters_k=2000, iters_p=100)
    t256 = time_lid(256, device, iters_k=TIME_ITERS, iters_p=20,
                    with_list=True)
    copy = copy_rate(device)
    tv = time_vessel(full, device)
    free_device()
    # one collide-stream launch per branch at lid 256^3, and the force
    # path's instance at gravity_channel 256^3
    lid_units = get_case("lid_driven_cavity", n=16).units
    k1b_time = {}
    for label, kw in (("bgk", {}), ("trt", dict(collision="trt")),
                      ("mrt", dict(collision="mrt")),
                      ("smag", dict(smagorinsky_cs=0.15)),
                      ("carreau", dict(rheology=carreau_blood(lid_units))),
                      ("moving lid", dict(lid="bounceback"))):
        k1b_time[f"lid 256^3 {label}"] = time_k1a(
            get_case("lid_driven_cavity", n=256, **kw), device, TIME_ITERS,
            10, f"lid 256^3 {label}")
    k1b_time["gravity_channel 256^3 trt+force"] = time_k1a(
        get_case("gravity_channel", n=256, nz=256, collision="trt"), device,
        TIME_ITERS, 10, "gravity_channel 256^3")
    k1b_time["coronary full trt+carreau"] = time_k1a(
        blood, device, 1000, 5, "coronary full, fluid list")
    mark("3 (K1 timings)")
    k2_time = {}
    for label, name, kw in (
            ("lid 256^3 bgk", "lid_driven_cavity", dict(n=256)),
            ("lid 256^3 trt", "lid_driven_cavity", dict(n=256,
                                                         collision="trt")),
            ("gravity_channel 256^3 trt+force", "gravity_channel",
             dict(n=256, nz=256, collision="trt"))):
        k2_time[label] = time_pair(get_case(name, **kw), device, 100, label)
    mark("3 (K2 timings)")
    t256_bf16 = time_lid(256, device, iters_k=TIME_ITERS, iters_p=20,
                         dtype=torch.bfloat16)
    tv_bf16 = time_vessel(full, device, dtype=torch.bfloat16)
    k1_cy_bf16 = time_k1a(blood, device, 1000, 5,
                          "coronary full, fluid list", dtype=torch.bfloat16)
    k2_bf16_time = time_pair_bf16(get_case("lid_driven_cavity", n=256),
                                  device, 300, "lid 256^3 bgk")
    print(f"[3d] bf16 at lid 256^3 (ms a launch): K1a {t256_bf16['k1a']:.4f} "
          f"(fp32 {t256['k1a']:.4f}; plain {t256_bf16['k1a_plain']:.4f}; "
          f"bound {t256_bf16['k1a_bound']:.4f}), K3 {t256_bf16['k3']:.4f} "
          f"(fp32 {t256['k3']:.4f}; bound {t256_bf16['k3_bound']:.4f}), K2 "
          f"{k2_bf16_time['ms']:.4f} (fp32 {k2_time['lid 256^3 bgk']['ms']:.4f})"
          f"; coronary full K1a [bgk+bf16] {tv_bf16['k1a_live']:.4f} (fp32 "
          f"{tv['k1a_live']:.4f}), [trt+cy+bf16] {k1_cy_bf16['ms']:.4f} (fp32 "
          f"{k1b_time['coronary full trt+carreau']['ms']:.4f})", flush=True)
    mark("3d (bf16 timings)")
    ts = scalar_timings(full, u_full, device)
    del u_full
    mark("3 (K7, K8, K1e timings)")
    lid256 = get_case("lid_driven_cavity", n=256)
    th_lid = time_halo(lid256, 0, 4, device, "lid 256^3 on x")
    th_cor = time_halo(full, 1, 4, device, "coronary full on y")
    mark("3e (K1d timings)")

    # -- phase 4: the lid main path ----------------------------------------
    spec = get_case("lid_driven_cavity", n=256)
    held = torch.cuda.memory_allocated(device)
    sim = Simulation(spec, device=device)
    require(sim.cc.live_blocks is None,
            "the lid cavity launches K1a with a block list")
    torch.cuda.reset_peak_memory_stats(device)
    marks = []
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(max_steps=1000, time_save=250, verbose=False,
                  on_save=chunk_clock(marks))
    rho, u = sim.macro()
    torch.cuda.synchronize()
    lid_counts = dict(K.launches)
    require(lid_counts.get("lbm_collide_stream[bgk]") == 1000,
            f"K1a launched {lid_counts} in a 1000-step run")
    require(lid_counts.get("lbm_macro", 0) >= 1, "macro() did not launch K3")
    require(res.steps == 1000 and not res.converged,
            f"run took {res.steps} steps (converged={res.converged})")
    require(tuple(rho.shape) == (256,) * 3
            and tuple(u.shape) == (3,) + (256,) * 3, "macro() shapes")
    require(bool(torch.isfinite(rho).all() and torch.isfinite(u).all()),
            "non-finite fields after 1000 steps")
    u_lid = 0.15 / 2.4705
    fluid = sim.cc.fluid
    u_max = float(u.norm(dim=0)[fluid].max())
    rho_dev = float((rho[fluid] - 1.0).abs().max())
    # sanity bounds of a lid-driven spin-up (the exactness check is phase 3)
    require(u_max <= 2.0 * u_lid and rho_dev < 0.2,
            f"fields out of physical range: max|u| {u_max:.4g} (lid "
            f"{u_lid:.4g}), max|rho-1| {rho_dev:.3g}")
    vs = res.velsum_series
    require(len(vs) == 1000 and bool((vs > 0).all()) and vs[-1] > vs[0],
            "velsum series is not the spin-up of a driven cavity")
    peak = (torch.cuda.max_memory_allocated(device) - held) / 2**30
    lid1 = {"velsum": vs, "ms": res.elapsed_s / res.steps * 1e3,
            "chunks": chunk_ms(t0, marks, 250),
            "mlups_box": res.mlups_box, "rho": rho, "u": u,
            "f": sim.f.clone(),  # the profile below steps sim on
            "peak": peak}
    print(f"[4] lid main path 256^3: {res.steps} steps in "
          f"{res.elapsed_s:.3f} s = {lid1['ms']:.4f} "
          f"ms/step (host clock, synchronized; chunks of 250: "
          f"{lid1['chunks']}), mlups_box "
          f"{res.mlups_box:.1f}, mlups {res.mlups:.1f}, mlups_live "
          f"{res.mlups_live:.1f}; residual {res.residual:.3e}; max|u| "
          f"{u_max:.4g}, max|rho-1| {rho_dev:.3g}; peak device memory "
          f"{lid1['peak']:.2f} GiB above what was held before; launches "
          f"{lid_counts}", flush=True)
    by_name, busy = profile_run(sim, 200)
    print_profile("[4] lid main path", by_name, busy, lid1["ms"])
    del sim, rho, u, fluid
    free_device()
    mark("4")

    # -- phase 16a: the sharded lid path on the one card ------------------
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        ref = os.path.join(tmp, "lid.npy")
        np.save(ref, lid1["f"].cpu().numpy())
        # the lid's shards launch over their boxes
        sh_lid = sharded_path("lid 256^3 on x", "lid_driven_cavity",
                              dict(n=256), 4, 1000, 250, ref, lid1["velsum"],
                              1000, "lbm_collide_stream[bgk+halo]")
    free_device()
    mark("16a")

    # -- phase 13: the fuse2 path ------------------------------------------
    fuse2_counts, fuse2_odd, fuse2_metrics = fuse2_path(device, lid1)
    free_device()
    mark("13")

    # -- phase 15a, 15c: the bf16 lid paths, fuse=1 and fuse=2 --------------
    lid16 = bf16_lid_path(device, lid1, 1)
    lid16_pair = bf16_lid_path(device, lid1, 2)
    e_u = rel_l2(lid16_pair.pop("u"), lid16["u"])
    v_rel = float(abs(lid16_pair["velsum"] - lid16["velsum"]).max()
                  / abs(lid16["velsum"]).min())
    print(f"[15] bf16 fuse2 path against the bf16 fuse=1 path (one "
          f"narrowing a pair against one a step): velsum series max rel diff "
          f"{v_rel:.3e}, macro() u rel L2 {e_u:.3e}", flush=True)
    del lid1, lid16["u"]
    free_device()
    mark("15a, 15c")

    # -- phase 5: the vessel path ------------------------------------------
    u_in = 0.1745 / 2.74909090909091
    counts, vp = vessel_path(full, device, "[5] vessel path", "bgk",
                             tv["live_share"])
    mark("5")

    # -- phase 6: the blood path -------------------------------------------
    blood_counts, blood_vp = vessel_path(
        blood, device, "[6] blood path (trt + Carreau blood)", "trt+cy",
        tv["live_share"], closure=True)
    del blood
    free_device()
    mark("6")

    # -- phase 15b: the bf16 vessel path -------------------------------------
    bf16_counts, bf16_vp = vessel_path(
        full, device, "[15] bf16 vessel path", "bgk+bf16", tv["live_share"],
        store_dtype="bf16")
    free_device()
    mark("15b")

    # -- phase 7: the force path -------------------------------------------
    force_counts = force_path(device)
    free_device()
    mark("7")

    # -- phase 9: the washout path (its flow's u kept for phase 20) --------
    washout_counts, washout_vp = washout_path(
        device, os.path.join(p20_dir.name, "u.npy"))
    mark("9")

    # -- phases 16b and 20: the sharded coronary path and the sharded -----
    # transports and windkessel route, in one spawn of 4 gloo ranks on the
    # one card
    t20 = time.perf_counter()
    p20_calls, p20_ref = sharded_transports_path(device, p20_dir.name,
                                                 p20_dense)
    t20 = time.perf_counter() - t20
    vspec = dataclasses.replace(full, residual_flavor="velsum")
    sim = Simulation(vspec, device=device)
    res = sim.run(max_steps=200, time_save=100, verbose=False)
    print(f"[16] coronary full, the unsharded run with the 'velsum' "
          f"residual: {res.steps} steps, {res.elapsed_s / res.steps * 1e3:.4f} "
          "ms/step", flush=True)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        ref = os.path.join(tmp, "coronary.npy")
        np.save(ref, sim.f_standard().cpu().numpy())
        ref_vs, ref_steps = res.velsum_series, res.steps
        del sim, res
        free_device()
        sh_cor = sharded_path("coronary full on y", "coronary",
                              FULL_CORONARY, 4, 200, 100, ref, ref_vs,
                              ref_steps, "lbm_collide_stream_list[bgk+halo]",
                              extra_calls=p20_calls)
    free_device()
    t_check = time.perf_counter()
    p20 = check_sharded_transports(sh_cor.pop("extra"), p20_ref, 4)
    os.remove(os.path.join(p20_dir.name, "f_wk.npy"))
    t20 += time.perf_counter() - t_check
    on_ranks = sum(p20[k]["seconds"] for k in ("washout", "clinical"))
    print(f"[t] phase 20 took {t20 + on_ranks:.1f} s: the references and "
          f"checks {t20:.1f} s, its (a) and (b) on the ranks {on_ranks:.1f} s "
          "(its small (c) and phase 16b share the spawn)", flush=True)
    mark("16b, 20")

    # -- phases 10, 11: coupled washout, thermal ----------------------------
    coupled_counts, coupled_vp = coupled_path(full, device)
    thermal_counts, thermal_trt_counts = thermal_path(device)
    mark("10, 11")

    # -- phase 18: the clinical coronary (windkessel outlets) -------------
    clin = clinical_path(device)
    mark("18")

    # -- phase 19: curved walls and the live-cell backend ------------------
    curved = dict(curved_path(device, full), curved=curved_a)
    free_device()
    mark("19")

    # -- phase 14: the lowmem path -----------------------------------------
    k4 = lowmem_path(device)
    mark("14")

    # -- phase 15d: the bf16 lowmem read --------------------------------------
    k4_bf16 = lowmem_read(device, "bf16", "[15] bf16 lowmem path")
    print(f"[15] bf16 lowmem path: f_standard() {k4_bf16['read_s']:.3f} s "
          f"against fp32's {k4['read_s']:.3f} s in phase 14", flush=True)
    mark("15d")

    # -- phase 8: the CLI --------------------------------------------------
    for case, opts, steps, want in (
            ("lid_driven_cavity", ["n=64"], "500",
             ["lid_driven_cavity_500.vtk"]),
            ("coronary", ["--vtk-final"], "200", ["coronary_200.vtk"]),
            ("gravity_channel", ["collision=trt", "n=64", "nz=64"], "500",
             ["gravity_channel_500.vtk"]),
            ("lid_driven_cavity", ["n=64", "--fuse", "2"], "500",
             ["lid_driven_cavity_500.vtk"]),
            ("coronary", ["--lowmem", "--checkpoint-every", "1",
                          "--vtk-final"], "200",
             ["coronary_200.vtk", "coronary.ckpt.npz"]),
            ("lid_driven_cavity", ["n=64", "--dtype", "bf16"], "500",
             ["lid_driven_cavity_500.vtk"]),
            ("coronary", ["--dtype", "bf16", "--lowmem", "--checkpoint-every",
                          "1", "--vtk-final"], "200",
             ["coronary_200.vtk", "coronary.ckpt.npz"])):
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") \
                as tmp:
            t0 = time.perf_counter()
            kv = [a for a in opts if "=" in a]
            args = [a for a in opts if a not in kv]
            argv = ["run", "--case", case, "--steps", steps, "--time-save",
                    "100", "--out", tmp, *args] + (["--opt", *kv] if kv
                                                    else [])
            proc = cli_run(argv)
            require(proc.returncode == 0,
                    f"CLI run of {case} failed ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            files = sorted(os.listdir(tmp))
            require("CONVERGENCE.log" in files
                    and all(w in files for w in want),
                    f"CLI outputs of {case} missing: {files}")
            if case == "coronary":
                with open(os.path.join(tmp, want[0])) as fh:
                    head = fh.read(1 << 16)
                require("SCALARS DENSITY float" in head,
                        "coronary VTK has no density")
            if "coronary.ckpt.npz" in want:
                import numpy as np

                with np.load(os.path.join(tmp, "coronary.ckpt.npz")) as ck:
                    require(ck["f"].dtype == np.float32,
                            f"CLI {opts}: checkpoint f is {ck['f'].dtype}")
            last = proc.stdout.strip().splitlines()[-2:]
            print(f"[8] CLI {case} {' '.join(opts)} run in "
                  f"{time.perf_counter() - t0:.1f} s wrote {files}; "
                  f"{' | '.join(last)}", flush=True)
    # --shard spawns its rank: a process of its own, started with the
    # build (cli_shard_start)
    cli_shard_wait(shard_cli)
    mark("8")
    nu32 = cli_transport_and_thermal()
    mark("12")
    p22 = bifurcation_path(device)
    p23 = phase23(device, p23_work, p23_disk, p23_started)

    # -- phase 17: several cards over NCCL --------------------------------
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        nccl_path(min(n_cards, 4), full, p20_dir.name)
        mark("17")
    else:
        print(f"[17] the NCCL path for several cards was not run on this "
              f"machine: it has {n_cards} card", flush=True)

    bt = k1b_time["coronary full trt+carreau"]
    ft = k1b_time["gravity_channel 256^3 trt+force"]
    kernels = [
        {"name": "lbm_collide_stream[bgk]", "route": "cuda",
         "source": K1A_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1333",
         "launches": lid_counts["lbm_collide_stream[bgk]"],
         "max_abs_err": errs["K1a"], "ms": t256["k1a"],
         "plain_ms": t256["k1a_plain"], "bound_ms": t256["k1a_bound"],
         "bound_by": "bytes", "library_ms": None,
         "ms_by": "cuda events, the lid 256^3 main path's box launch",
         "lid256_ms_every_cell": t256["full"],
         "lid256_ms_fluid_list": t256["list"],
         "card_copy_ms": copy["ms"], "card_copy_gb_per_s": copy["gb_per_s"],
         "registers": bgk[0], "spill_bytes": bgk[1] + bgk[2],
         "blocks_per_sm": k1_blocks["collide_stream_kernel[bgk]"],
         "coronary_every_cell_ms": tv["k1a_all"],
         "p23_profile_shard_launches": p23["e"]["v1_unsharded"]["launches"]},
        {"name": "lbm_collide_stream_list[bgk]", "route": "cuda",
         "source": K1_LIST_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1333 (K1c: the "
                     "live-tile list tids, live_tile_ids :2651)",
         "launches": counts["lbm_collide_stream_list[bgk]"],
         "max_abs_err": max(errs["K1a"], vp["developed_max_abs_err"]),
         "ms": tv["k1_device_ms"],
         "ms_by": "torch.profiler device time a launch on one state",
         "ms_events": tv["k1a_live"], "plain_ms": tv["k1a_plain"],
         "bound_ms": tv["k1a_bound"], "bound_by": "bytes",
         "library_ms": None, "lanes": tv["lanes"],
         "table_mb": tv["table_mb"],
         "registers": list_ptxas["collide_stream_list_kernel[bgk]"][0],
         "spill_bytes": sum(
             list_ptxas["collide_stream_list_kernel[bgk]"][1:3]),
         "blocks_per_sm": list_blocks["collide_stream_list_kernel[bgk]"],
         "vessel_path": vp, "coupled_washout_path": coupled_vp,
         "phase19_launches": curved["straight"]["kernel_launches"],
         "bifurcation_launches": p22["launches"][
             "lbm_collide_stream_list[bgk]"],
         "bifurcation_max_abs_err": p22["check_max_abs_err"]["k1a"],
         "bifurcation_fluid_cells": p22["fluid_cells"],
         "p23_launches": {
             "outputs_512_run": p23["a"]["launches"]["run"],
             "outputs_512_resume": p23["a"]["launches"]["resume"],
             "washout_512_flow": p23["b"]["flow_launches"],
             "profile_clinical": {
                 k: v["launches"] for k, v in p23["d"].items()
                 if "+wk" not in v["route"]}}},
        {"name": "lbm_collide_stream_list[trt+cy]", "route": "cuda",
         "source": K1_LIST_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1333 (K1b branches)",
         "launches": blood_counts["lbm_collide_stream_list[trt+cy]"],
         "max_abs_err": max(branch_err.values()),
         "max_abs_err_blood_path": max(
             branch_err["coronary full trt+carreau blood"],
             blood_vp["developed_max_abs_err"]),
         "ms": bt["device_ms"],
         "ms_by": "torch.profiler device time a launch on one state",
         "ms_events": bt["ms"], "plain_ms": bt["plain_ms"],
         "bound_ms": bt["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "blood_path": blood_vp,
         "box_branches_lid256": k1b_time,
         "max_abs_err_by_branch": branch_err,
         "registers": {k: v[0] for k, v in {**ptxas, **list_ptxas}.items()},
         "spill_bytes": {k: v[1] + v[2]
                         for k, v in {**ptxas, **list_ptxas}.items()},
         "build_s": [lib.build_seconds, llib.build_seconds]},
        {"name": "lbm_collide_stream[trt+force]", "route": "cuda",
         "source": K1A_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1333 (K1b branches)",
         "launches": force_counts["lbm_collide_stream[trt+force]"],
         "max_abs_err": max(branch_err["gravity_channel 32^3 trt+force"],
                            branch_err["gravity_channel 256^3 trt+force"]),
         "ms": ft["ms"], "plain_ms": ft["plain_ms"],
         "bound_ms": ft["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "lbm_collide_stream_list[bgk] z planes (K5+K6)",
         "route": "cuda", "source": K1_LIST_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:2695",
         "also_replaces": "lbm_tpu/kernels/collide_stream.py:2770",
         "lives_in": "the z-plane descriptors of lbm_collide_stream_list "
                     "(collide_stream_list.cuh collide_stream_segs): the "
                     "coronary's three z planes in every K1 launch",
         "launches": counts["lbm_collide_stream_list[bgk]"],
         "max_abs_err": max(errs["Kz"], k1b_errs["Kz"]),
         "ms": tv["z_device_ms"],
         "ms_by": "torch.profiler device time of K1 over the fluid cells "
                  "with its z descriptors minus without them",
         "ms_events": tv["z_ms"],
         "plain_ms": tv["z_plain"], "bound_ms": tv["z_bound"],
         "bound_by": "bytes", "library_ms": None,
         "k1_with_z_ms": tv["k1_device_ms"],
         "k1_without_z_ms": tv["k1_device_ms_no_z"],
         "blood_launches": blood_counts["lbm_collide_stream_list[trt+cy]"]},
        {"name": "lbm_windkessel_flux", "route": "cuda",
         "source": WK_SOURCE,
         "replaces": "lbm_tpu/engine/step.py:138 (the windkessel flux of "
                     "the fixups lbm_tpu runs after its kernel, "
                     "lbm_tpu/kernels/collide_stream.py:3198): here the "
                     "prime of the fold, once a chunk",
         "launches": clin["counts"]["lbm_windkessel_flux"],
         "max_abs_err": max(e["rho"] for e in clin["errs"].values()),
         "bit_equal_by_case": {k: e["prime_bit_equal"]
                               for k, e in clin["errs"].items()},
         "ms": clin["flux_ms"], "device_ms": clin["flux_device_ms"],
         "plain_ms": clin["flux_plain_ms"],
         "bound_ms": clin["flux_bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "registers": {k: v[0] for k, v in ptxas_wk.items()
                       if k.startswith("windkessel_flux_kernel")},
         "build_s": wlib.build_seconds,
         "coupled_launches": clin["coupled_counts"]["lbm_windkessel_flux"]},
        {"name": "lbm_collide_stream[bgk+wk] (the windkessel fold: K5+K6 "
                 "windkessel branch and the flux)", "route": "cuda",
         "source": WK_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:2742",
         "also_replaces": "lbm_tpu/kernels/collide_stream.py:2793, "
                          "::_fix_xy_plane_windowed :2342 and the flux of "
                          "lbm_tpu/engine/step.py:138",
         "bf16_source": WK_BF16_SOURCE,
         "lives_in": "collide_stream_wk_kernel (windkessel.cuh over "
                     "collide_stream.cuh) and velsum_reduce_wk_kernel",
         "launches": clin["counts"]["lbm_collide_stream[bgk+wk]"],
         "max_abs_err": max(e["f"] for e in clin["errs"].values()),
         "max_abs_err_by_case": {k: e["f"] for k, e in clin["errs"].items()},
         "max_rel_err_pc": max(e["pc"] for e in clin["errs"].values()),
         "bit_equal_by_case": {k: e["bit_equal"]
                               for k, e in clin["errs"].items()},
         "q_at_start_by_case": {k: e["q0"] for k, e in clin["errs"].items()},
         "ms": clin["k1_device_ms"],
         "ms_by": "torch.profiler device time a launch on the clinical path",
         "reduce_device_ms": clin["reduce_device_ms"],
         "step_ms": clin["step_ms"], "step_plain_ms": clin["step_plain_ms"],
         "plain_ms": clin["step_plain_ms"],
         "bound_ms": clin["k1_bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "registers": {k: v[0] for k, v in ptxas_wk.items()
                       if k.startswith("collide_stream_kernel[")},
         "spill_bytes": {k: v[1] + v[2] for k, v in ptxas_wk.items()
                         if k.startswith("collide_stream_kernel[")},
         "blocks_per_sm": fold_blocks,
         "build_s": [wlib.build_seconds, wlib16.build_seconds],
         "clinical_path": clin["path"], "pc_recurrence": clin["pc_recurrence"],
         "wss": clin["wss"], "clinical_coupled_path": clin["coupled"],
         "coupled_launches": clin["coupled_counts"][
             "lbm_collide_stream[bgk+wk]"],
         "p23_profile_clinical_launches": {
             k: v["launches"] for k, v in p23["d"].items()
             if "+wk" in v["route"]}},
        {"name": "lbm_macro", "route": "cuda", "source": K1A_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:2470",
         "launches": counts["lbm_macro"],
         "max_abs_err": max(errs["K3"], k1b_errs["K3"]), "ms": tv["k3"],
         "plain_ms": tv["k3_plain"], "bound_ms": tv["k3_bound"],
         "bound_by": "bytes", "library_ms": tv["k3_library"],
         "force_shift_max_abs_err": k1b_errs["K3_force"],
         "force_launches": force_counts["lbm_macro[force]"],
         "lid256_launches": lid_counts["lbm_macro"],
         "bifurcation_launches": p22["launches"]["lbm_macro"],
         "bifurcation_max_abs_err": p22["check_max_abs_err"]["k3"],
         "lid256_ms": t256["k3"], "lid256_plain_ms": t256["k3_plain"],
         "lid256_bound_ms": bound_ms(256**3 * (19 * 4 + 4 * 4)),
         "lid256_library_ms": t256["k3_library"],
         "p23_launches": {"macro_512": p23["a"]["launches"]["macro"],
                          "vtk_512": p23["a"]["launches"]["vtk"]}},
        {"name": "lbm_scalar_stream[frozen+comp]", "route": "cuda",
         "source": K7_SOURCE,
         "replaces": "lbm_tpu/kernels/scalar_stream.py:507 (K7, _subtile7 "
                     ":141)",
         "launches": washout_counts["lbm_scalar_stream[frozen+comp]"],
         "max_abs_err": max(scalar_err["frozen+comp"],
                            scalar_err["frozen"]),
         "max_abs_err_washout_path": path_err["washout"],
         "record_series_max_abs_err": scalar_err["record series"],
         "ms": ts["k7_coronary"]["ms"],
         "plain_ms": ts["k7_coronary"]["plain_ms"],
         "bound_ms": ts["k7_coronary"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "at_256": ts["k7_256"],
         "listed_cells": ts["k7_coronary"]["listed_cells"],
         "fluid_cells": ts["k7_coronary"]["fluid_cells"],
         "record_ms": ts["k7_coronary"]["record_ms"],
         "record_device_ms": washout_vp["record_ms"],
         "record_plain_ms": ts["k7_coronary"]["record_plain_ms"],
         "record_bound_ms": ts["k7_coronary"]["record_bound_ms"],
         "footprint_cells": ts["k7_coronary"]["footprint_cells"],
         "washout_path": washout_vp,
         "p23_washout_512_launches": p23["b"]["launches"],
         "registers": {k: v[0] for k, v in ptxas.items()
                       if k.startswith("scalar")},
         "build_s": slib.build_seconds},
        {"name": "lbm_scalar_stream[frozen+comp] on a halo-row block "
                 "(sharded)", "route": "cuda",
         "source": K7_SOURCE,
         "replaces": "lbm_tpu/kernels/scalar_stream.py:507 (K7 under "
                     "ScalarTransportPallas(mesh=): _build_sharded :730, "
                     "_sharded_step :900)",
         "launches": sum(p20["washout"]["launches_per_rank"]),
         "launches_per_rank": p20["washout"]["launches_per_rank"],
         "max_abs_err": p20["washout"]["timing"]["max_abs_err"],
         "ms": p20["washout"]["timing"]["ms"],
         "plain_ms": p20["washout"]["timing"]["plain_ms"],
         "bound_ms": p20["washout"]["timing"]["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "block_shape": p20["washout"]["timing"]["shape"],
         "listed_cells": p20["washout"]["timing"]["listed_cells"],
         "unsharded_same_shape_ms": p20["washout"]["timing"]["unsharded_ms"],
         "unsharded_same_shape_bound_ms":
             p20["washout"]["timing"]["unsharded_bound_ms"],
         "path_ms_per_step_one_card": p20["washout"]["ms"],
         "path_exchange_ms_one_card": p20["washout"]["exchange_ms"],
         "path_record_max_abs_err": p20["washout"]["series_max_abs_err"],
         "path_peak_gib_per_rank": p20["washout"]["peak_gib"],
         "clinical_dense_route": p20["clinical"],
         "small_dense_transports": p20["small"]},
        {"name": "lbm_scalar_stream[live]", "route": "cuda",
         "source": K7_SOURCE,
         "replaces": "lbm_tpu/kernels/scalar_stream.py:507 (K8, _subtile7f "
                     ":220)",
         "launches": coupled_counts["lbm_scalar_stream[live]"],
         "max_abs_err": scalar_err["live"],
         "max_abs_err_coupled_path": path_err["coupled washout"],
         "ms": ts["k8_coronary"]["ms"],
         "plain_ms": ts["k8_coronary"]["plain_ms"],
         "bound_ms": ts["k8_coronary"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "listed_cells": ts["k8_coronary"]["listed_cells"],
         "p23_profile_clinical_launches": {
             k: v["launches"] for k, v in p23["d"].items()
             if "lbm_scalar_stream[live]" in v["launches"]},
         "coupled_washout_path": coupled_vp},
        {"name": "lbm_scalar_stream[live+force+dirichlet]", "route": "cuda",
         "source": K7_SOURCE,
         "replaces": "lbm_tpu/kernels/scalar_stream.py:507 (K8 with the "
                     "Boussinesq force, _subtile7f :220)",
         "launches": thermal_counts[
             "lbm_scalar_stream[live+force+dirichlet]"],
         "max_abs_err": max(scalar_err["live+force+dirichlet"],
                            scalar_err["live+force"]),
         "max_abs_err_thermal_path": max(path_err["thermal bgk"],
                                         path_err["thermal trt"]),
         "ms": ts["k8_256"]["ms"], "plain_ms": ts["k8_256"]["plain_ms"],
         "bound_ms": ts["k8_256"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "cli_nu_n32": nu32},
        {"name": "lbm_collide_stream[bgk+field]", "route": "cuda",
         "source": K1A_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1333 (K1e, fforce "
                     ":647-675)",
         "launches": thermal_counts["lbm_collide_stream[bgk+field]"],
         "max_abs_err": max(scalar_err["bgk+field"],
                            scalar_err["bgk+field+moving"]),
         "max_abs_err_thermal_path": path_err["thermal bgk"],
         "ms": ts["k1e_256"]["ms"], "plain_ms": ts["k1e_256"]["plain_ms"],
         "bound_ms": ts["k1e_256"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "lbm_collide_stream[trt+field]", "route": "cuda",
         "source": K1A_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1333 (K1e, fforce "
                     ":647-675)",
         "launches": thermal_trt_counts["lbm_collide_stream[trt+field]"],
         "max_abs_err": max(scalar_err["trt+field"],
                            scalar_err["trt+field+moving"]),
         "max_abs_err_thermal_path": path_err["thermal trt"],
         "ms": ts["k1e_trt_256"]["ms"],
         "plain_ms": ts["k1e_trt_256"]["plain_ms"],
         "bound_ms": ts["k1e_trt_256"]["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "registers": {k: v[0] for k, v in trt_field.items()},
         "spill_bytes": {k: v[1] + v[2] for k, v in trt_field.items()},
         "blocks_per_sm": {k: k1_blocks[k] for k in trt_field}},
        {"name": "lbm_collide_stream2[bgk]", "route": "cuda",
         "source": K2_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1727 (K2, "
                     "_pallas_bulk2 :2055)",
         "launches": fuse2_counts["lbm_collide_stream2[bgk]"],
         "max_abs_err": max(k2_err.values()),
         "max_abs_err_by_case": k2_err,
         "ms": k2_time["lid 256^3 bgk"]["ms"],
         "plain_ms": k2_time["lid 256^3 bgk"]["plain_ms"],
         "bound_ms": k2_time["lid 256^3 bgk"]["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "two_k1_launches_ms": k2_time["lid 256^3 bgk"]["two_k1_ms"],
         "branches": k2_time, "odd_chunk_launches": fuse2_odd,
         "path_ms_per_step": fuse2_metrics["ms_step"],
         "path_device_ms_per_launch": fuse2_metrics["k2_device_ms"],
         "path_busy_share": fuse2_metrics["busy"],
         "developed_ms": fuse2_metrics["k2_developed_ms"],
         "developed_two_k1_launches_ms": fuse2_metrics["two_k1_developed_ms"],
         "registers": {k: v[0] for k, v in k2_ptxas.items()},
         "spill_bytes": {k: v[1] + v[2] for k, v in k2_ptxas.items()},
         "smem_bytes_per_block": pair_smem + max(
             smem.get(k, 0) for k in k2_ptxas),
         "blocks_per_sm": pair_occ, "unit_x_y_z": pair_unit,
         "build_s": plib.build_seconds},
        {"name": "lbm_extract_rows", "route": "cuda", "source": K2_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:2586",
         "launches": k4["launches"],
         "max_abs_err": max(k4["max_abs_err"], k4_err), "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": "bytes", "library_ms": k4["library_ms"],
         "chunk_mb": k4["chunk_mb"], "read_512_s": k4["read_s"],
         "p23_checkpoint_launches": p23["a"]["launches"]["checkpoint"],
         "read_512_gb_per_s": k4["read_gb_per_s"],
         "device_rise_mb": k4["device_rise_mb"],
         "registers": {k: v[0] for k, v in ptxas.items()
                       if k.startswith("extract_rows")}},
        {"name": "lbm_collide_stream[bgk+bf16]", "route": "cuda",
         "source": K1A_BF16_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1333 (bf16 storage: "
                     "_subtile_compute :626-646, _row_fix :1083-1094, "
                     "_vs_sum :306-315)",
         "launches": lid16["counts"]["lbm_collide_stream[bgk+bf16]"],
         "max_abs_err": max(bf16_err.values()),
         "max_abs_err_by_case": bf16_err,
         "values_differing_by_case": bf16_diff,
         "ms": t256_bf16["k1a"], "plain_ms": t256_bf16["k1a_plain"],
         "bound_ms": t256_bf16["k1a_bound"], "bound_by": "bytes",
         "library_ms": None, "fp32_ms": t256["k1a"],
         "path_ms_per_step": lid16["ms"],
         "path_mlups_box": lid16["mlups_box"],
         "path_rel_l2_u_vs_fp32": lid16["rel_l2_u"],
         "path_rel_l2_u_vs_fp32_driven_rows": lid16["rel_l2_u_driven"],
         "path_rel_l2_u_vs_fp32_resting_bulk": lid16["rel_l2_u_bulk"],
         "path_busy_share": lid16["busy"],
         "div_exact_mismatches_of_2pow32": div_bad,
         "vessel_launches": bf16_counts["lbm_collide_stream[bgk+bf16]"],
         "coronary_ms_live": tv_bf16["k1a_live"],
         "coronary_plain_ms": tv_bf16["k1a_plain"],
         "coronary_bound_ms": tv_bf16["k1a_bound"],
         "coronary_ms_every_cell": tv_bf16["k1a_all"],
         "trt_cy_bf16_coronary": k1_cy_bf16,
         "registers": {k: v[0] for k, v in ptxas_bf16.items()},
         "spill_bytes": {k: v[1] + v[2] for k, v in ptxas_bf16.items()},
         "build_s": blib.build_seconds},
        {"name": "lbm_collide_stream[bgk+bf16] z planes (K5+K6)",
         "route": "cuda", "source": K1A_BF16_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:2695 (its bf16 "
                     "write)",
         "also_replaces": "lbm_tpu/kernels/collide_stream.py:2770 (its bf16 "
                          "read)",
         "lives_in": "the z-plane descriptors of lbm_collide_stream_bf16",
         "launches": bf16_counts["lbm_collide_stream[bgk+bf16]"],
         "max_abs_err": bf16_z,
         "ms": tv_bf16["z_ms"],
         "ms_by": "cuda events: K1 bf16 over the fluid list with its z "
                  "descriptors minus without them",
         "plain_ms": tv_bf16["z_plain"], "bound_ms": tv_bf16["z_bound"],
         "bound_by": "bytes", "library_ms": None,
         "k1_with_z_ms": tv_bf16["k1a_live_again"],
         "k1_without_z_ms": tv_bf16["k1a_no_z"],
         "vessel_path": bf16_vp},
        {"name": "lbm_macro[bf16]", "route": "cuda", "source": K1A_BF16_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:2470 (its bf16 read)",
         "launches": bf16_counts["lbm_macro[bf16]"], "max_abs_err": bf16_k3,
         "ms": tv_bf16["k3"], "plain_ms": tv_bf16["k3_plain"],
         "bound_ms": tv_bf16["k3_bound"], "bound_by": "bytes",
         "library_ms": tv_bf16["k3_library"],
         "library_call": "torch.matmul on the widened state",
         "lid256_launches": lid16["counts"]["lbm_macro[bf16]"],
         "lid256_ms": t256_bf16["k3"], "lid256_plain_ms": t256_bf16["k3_plain"],
         "lid256_bound_ms": t256_bf16["k3_bound"],
         "lid256_library_ms": t256_bf16["k3_library"]},
        {"name": "lbm_collide_stream2[bgk+bf16]", "route": "cuda",
         "source": K2_BF16_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1727 (K2 on bf16 "
                     "storage, f32 mid tile :2084-2086)",
         "launches": lid16_pair["counts"]["lbm_collide_stream2[bgk+bf16]"],
         "max_abs_err": max(v[0] for v in k2_bf16.values()),
         "against_two_bf16_k1_launches": {
             k: {"values_differing": v[1], "max_abs": v[2]}
             for k, v in k2_bf16.items()},
         "ms": k2_bf16_time["ms"], "plain_ms": k2_bf16_time["plain_ms"],
         "bound_ms": k2_bf16_time["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "two_k1_launches_ms": k2_bf16_time["two_k1_ms"],
         "path_ms_per_step": lid16_pair["ms"],
         "path_busy_share": lid16_pair["busy"],
         "developed_ms": lid16_pair["k2_developed_ms"],
         "developed_two_k1_launches_ms": lid16_pair["two_k1_developed_ms"],
         "registers": {k: v[0] for k, v in ptxas_bf16.items()
                       if k.startswith("collide_stream2")},
         "spill_bytes": {k: v[1] + v[2] for k, v in ptxas_bf16.items()
                         if k.startswith("collide_stream2")},
         "build_s": bplib.build_seconds},
        {"name": "lbm_extract_rows[bf16]", "route": "cuda",
         "source": K2_BF16_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:2586 (bf16 rows)",
         "launches": k4_bf16["launches"],
         "max_abs_err": k4_bf16["max_abs_err"], "ms": k4_bf16["ms"],
         "plain_ms": k4_bf16["plain_ms"], "bound_ms": k4_bf16["bound_ms"],
         "bound_by": "bytes", "library_ms": k4_bf16["library_ms"],
         "chunk_mb": k4_bf16["chunk_mb"], "read_512_s": k4_bf16["read_s"],
         "read_512_gb_per_s": k4_bf16["read_gb_per_s"],
         "fp32_read_512_s": k4["read_s"],
         "device_rise_mb": k4_bf16["device_rise_mb"]},
        {"name": "lbm_collide_stream_list[bgk+halo]", "route": "cuda",
         "source": K1D_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1386 (K1d: _kernel's "
                     "halo_axis branch, _HaloSplitCopy :1610; called from "
                     "lbm_tpu/parallel/pallas_sharded.py:445), over the "
                     "shard's fluid cells",
         "launches": sh_cor["launches"],
         "launches_per_rank": sh_cor["launches"] // 4,
         "max_abs_err": max(halo_err.values()),
         "max_abs_err_by_case": halo_err,
         "ms": th_cor["device_ms"],
         "ms_by": "torch.profiler device time a launch",
         "ms_events": th_cor["ms"], "plain_ms": th_cor["plain_ms"],
         "bound_ms": th_cor["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "k1a_same_shard_ms": th_cor["k1a_ms"],
         "k1a_same_shard_device_ms": th_cor["k1a_device_ms"],
         "local_shape": th_cor["shape"], "shard_axis": "y",
         "path_ms_per_step_one_card": sh_cor["ms"],
         "path_exchange_ms_one_card": sh_cor["exchange_ms"],
         "path_velsum_rel_err": sh_cor["velsum_rel_err"],
         "p23_sharded_512_launches_per_rank": p23["c"]["launches"],
         "registers": {k: v[0] for k, v in ptxas_halo.items()},
         "spill_bytes": {k: v[1] + v[2] for k, v in ptxas_halo.items()},
         "build_s": [h.build_seconds for h in hlibs]},
        {"name": "lbm_collide_stream[bgk+halo]", "route": "cuda",
         "source": K1D_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1386 (K1d: _kernel's "
                     "halo_axis branch), over the shard's box",
         "launches": sh_lid["launches"],
         "max_abs_err": max(halo_err.values()),
         "ms": th_lid["ms"], "plain_ms": th_lid["plain_ms"],
         "bound_ms": th_lid["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "k1a_same_shard_ms": th_lid["k1a_ms"],
         "device_ms": th_lid["device_ms"],
         "k1a_same_shard_device_ms": th_lid["k1a_device_ms"],
         "local_shape": th_lid["shape"], "shard_axis": "x",
         "path_ms_per_step_one_card": sh_lid["ms"],
         "path_exchange_ms_one_card": sh_lid["exchange_ms"],
         "p23_profile_shard_launches": {
             k: v["launches"] for k, v in p23["e"].items()
             if k != "v1_unsharded"}},
        {"name": "lbm_collide_stream_list[bgk+halo] z planes",
         "route": "cuda", "source": K1D_SOURCE,
         "replaces": "lbm_tpu/parallel/pallas_sharded.py:380 (the sharded "
                     "z fixup: K6's slab with its shard-edge rows patched "
                     "from the planes, K5's splice :452-465)",
         "lives_in": "the z-plane descriptors of "
                     "lbm_collide_stream_halo_list",
         "launches": sh_cor["launches"],
         "z_windows_over_the_ranks": sh_cor["z_windows"],
         "max_abs_err": max(halo_err.values()),
         "ms": th_cor.get("z_ms"),
         "ms_by": "torch.profiler device time of K1d with its z "
                  "descriptors minus without them, on the shard timed",
         "plain_ms": th_cor.get("z_plain_ms"),
         "bound_ms": th_cor.get("z_bound_ms"), "bound_by": "bytes",
         "library_ms": None},
    ]
    print(f"[done] ms at 64^3: K1a {t64['k1a']:.4f} plain "
          f"{t64['k1a_plain']:.4f}, K3 {t64['k3']:.4f} plain "
          f"{t64['k3_plain']:.4f}; total "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    curved["pipe"] = pipe
    print(json.dumps({"phase19": curved}), flush=True)
    print(json.dumps({"phase21": p21}, default=float), flush=True)
    print(json.dumps({"phase22": p22}, default=float), flush=True)
    print(json.dumps({"phase23": p23}, default=float), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(nccl_main() if sys.argv[1:] == ["--nccl"] else
             phase21_main() if sys.argv[1:] == ["--phase21"] else
             phase22_main() if sys.argv[1:] == ["--phase22"] else
             phase23_main() if sys.argv[1:] == ["--phase23"] else main())
