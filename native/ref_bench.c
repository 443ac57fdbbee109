/* Measured CPU baseline driver for the GCGE reference library.
 *
 * BASELINE.md requires the reference's numbers to be MEASURED, not cited
 * (the upstream repo publishes no benchmarks).  This driver links against
 * the unmodified reference sources (/root/reference/src, /root/reference/app
 * — compiled to objects by native/Makefile, never copied into this repo),
 * builds the same 3D 27-point Laplacian the GPU bench uses (bench.py), and
 * runs the reference GCG eigensolver through its public setup protocol
 * (mirroring /root/reference/test/test_eig_sol_gcg.c:28-140) with the
 * production parameterization of /root/reference/test/submit.sh:34-44.
 *
 * Output: one line  "REF_BASELINE wall_s=... numIter=... nevConv=..." that
 * bench.py consumes for its vs_baseline ratio.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <float.h>
#include <time.h>

#include "ops.h"
#include "app_ccs.h"
#include "ops_eig_sol_gcg.h"

/* 3D 27-point Laplacian on an nx^3 grid in CSC layout: column j holds the
 * (up to 27) neighbors of grid point j; iterating the offset cube in
 * lexicographic order emits row indices in ascending order, as CCS wants. */
static CCSMAT create_27pt(int nx)
{
	long long n = (long long)nx * nx * nx;
	long long cap = 27LL * n;
	CCSMAT a;
	a.nrows = (int)n;
	a.ncols = (int)n;
	a.data  = (double *)malloc(cap * sizeof(double));
	a.i_row = (int *)malloc(cap * sizeof(int));
	a.j_col = (int *)malloc((n + 1) * sizeof(int));
	long long nnz = 0;
	int x, y, z, dx, dy, dz;
	for (x = 0; x < nx; ++x)
	for (y = 0; y < nx; ++y)
	for (z = 0; z < nx; ++z) {
		long long j = ((long long)x * nx + y) * nx + z;
		a.j_col[j] = (int)nnz;
		for (dx = -1; dx <= 1; ++dx)
		for (dy = -1; dy <= 1; ++dy)
		for (dz = -1; dz <= 1; ++dz) {
			int xx = x + dx, yy = y + dy, zz = z + dz;
			if (xx < 0 || xx >= nx || yy < 0 || yy >= nx ||
			    zz < 0 || zz >= nx)
				continue;
			a.i_row[nnz] = (int)(((long long)xx * nx + yy) * nx + zz);
			a.data[nnz] = (dx == 0 && dy == 0 && dz == 0) ? 26.0 : -1.0;
			++nnz;
		}
	}
	a.j_col[n] = (int)nnz;
	return a;
}

static double wtime(void)
{
	struct timespec ts;
	clock_gettime(CLOCK_MONOTONIC, &ts);
	return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

/* Load a CSC matrix from the simple binary format written by
 * benchmarks/irregular.py (gcge_tpu.io.loaders.write_ccs_binary):
 *   int64 n, int64 nnz, int64 j_col[n+1], int32 i_row[nnz], f64 data[nnz]
 * Lets the reference measure the SAME irregular matrices the GPU bench
 * solves (the reference rig's SuiteSparse files are not fetchable here). */
static CCSMAT load_ccs(const char *path)
{
	FILE *f = fopen(path, "rb");
	if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(1); }
	long long n = 0, nnz = 0, j;
	if (fread(&n, 8, 1, f) != 1 || fread(&nnz, 8, 1, f) != 1) exit(1);
	CCSMAT a;
	a.nrows = (int)n;
	a.ncols = (int)n;
	a.j_col = (int *)malloc((n + 1) * sizeof(int));
	a.i_row = (int *)malloc(nnz * sizeof(int));
	a.data = (double *)malloc(nnz * sizeof(double));
	long long *jc = (long long *)malloc((n + 1) * sizeof(long long));
	if (fread(jc, 8, n + 1, f) != (size_t)(n + 1)) exit(1);
	for (j = 0; j <= n; ++j) a.j_col[j] = (int)jc[j];
	free(jc);
	if (fread(a.i_row, 4, nnz, f) != (size_t)nnz) exit(1);
	if (fread(a.data, 8, nnz, f) != (size_t)nnz) exit(1);
	fclose(f);
	return a;
}

int main(int argc, char *argv[])
{
	int nx = 54, nev = 50, max_iter = 500, cg_max_iter = 30;
	const char *file_a = NULL, *file_b = NULL;
	int i;
	for (i = 1; i + 1 < argc; i += 2) {
		if (!strcmp(argv[i], "-nx")) nx = atoi(argv[i + 1]);
		if (!strcmp(argv[i], "-nev")) nev = atoi(argv[i + 1]);
		if (!strcmp(argv[i], "-maxIter")) max_iter = atoi(argv[i + 1]);
		if (!strcmp(argv[i], "-cgIter")) cg_max_iter = atoi(argv[i + 1]);
		if (!strcmp(argv[i], "-matA")) file_a = argv[i + 1];
		if (!strcmp(argv[i], "-matB")) file_b = argv[i + 1];
	}

	OPS *ops = NULL;
	OPS_Create(&ops);
	OPS_CCS_Set(ops);
	OPS_Setup(ops);

	CCSMAT a = file_a ? load_ccs(file_a) : create_27pt(nx);
	CCSMAT b;
	void *mat_a = (void *)&a;
	void *mat_b = NULL;
	if (file_b) {
		b = load_ccs(file_b);
		mat_b = (void *)&b;
	}

	/* production parameterization (submit.sh:34-44): bs = nev/5,
	 * nevMax = 2*nev, nevInit = nevMax, tol = {1e-1, 1e-8} */
	int nev_conv = nev, multi_max;
	double gap_min = 0.01;
	int block_size = nev / 5, nev_max = 2 * nev, nev_init;
	if (block_size < 1) block_size = 1;
	multi_max = block_size;
	nev_init = nev_max;
	double tol[2] = {1e-1, 1e-8};

	double *eval = (double *)calloc(nev_max, sizeof(double));
	void **evec;
	ops->MultiVecCreateByMat(&evec, nev_max, mat_a, ops);
	ops->MultiVecSetRandomValue(evec, 0, nev_max, ops);

	void **mv_ws[4];
	double *dbl_ws;
	int *int_ws;
	EigenSolverCreateWorkspace_GCG(nev_init, nev_max, block_size, mat_a,
				       mv_ws, &dbl_ws, &int_ws, ops);

	srand(0);
	EigenSolverSetup_GCG(multi_max, gap_min, nev_init, nev_max, block_size,
			     tol, max_iter, 0, mv_ws, dbl_ws, int_ws, ops);
	EigenSolverSetParameters_GCG(
		block_size,                         /* check_conv_max_num */
		"mgs", 80, 2, 2 * DBL_EPSILON,      /* initX orth */
		"mgs", -1, 2, 2 * DBL_EPSILON,      /* compP orth */
		"mgs", 80, 2, 2 * DBL_EPSILON,      /* compW orth */
		cg_max_iter, 1e-2, 1e-14, "abs", 0, /* compW bpcg */
		-1, gap_min, 2 * DBL_EPSILON,       /* compRR */
		ops);

	double t0 = wtime();
	ops->EigenSolver(mat_a, mat_b, eval, evec, 0, &nev_conv, ops);
	double wall = wtime() - t0;

	int num_iter = ((GCGSolver *)ops->eigen_solver_workspace)->numIter;
	printf("eigenvalues:");
	for (i = 0; i < (nev < 6 ? nev : 6); ++i)
		printf(" %.12e", eval[i]);
	printf("\n");
	printf("REF_BASELINE wall_s=%.3f numIter=%d nevConv=%d n=%d nnz=%d\n",
	       wall, num_iter, nev_conv, a.nrows, a.j_col[a.ncols]);
	return 0;
}
